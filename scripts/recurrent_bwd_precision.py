"""How precise the decay gradients of K4's and K5's backward formulas are,
on the CPU, against float64 autograd of the step-by-step recurrences.

The backward kernels share their formulas with ``wkv6_bwd_plain`` and
``ssd_bwd_plain``.  Each log-decay gradient can be taken two ways: as a
reverse cumulative sum of terms that the other gradients already give
(K4: r o dr' - k o dk'; K5: C . dC - x . dx), anchored on the state
against its adjoint, or term by term.  This script prints, for each case,
the largest error of each form over the float64 gradient's largest entry,
the worst over a few seeds:
  * K4 ``dlogw``: the port's form (reverse sums re-anchored at every
    32-step chunk) in exact fp32 and with every product rounded as the
    backward kernels' TF32 x 3 tensor-core products round it (``tf32x3``),
    and the same sums anchored once, at the sequence's end;
  * K5 ``dA``: the port's form (term by term) and the reverse sums,
    anchored at every chunk and once.
With ``--sensitivity`` it also prints how far a rwkv6's gradients move
when WKV's output is scaled by (1 + 1e-6 noise), at full width with a
small vocab, for a few depths (slow: about a minute a depth).  With
``--card`` that runs on the GPU at chip_smoke phase 13 C's shape (B=4 x
2048 tokens, the full vocab, remat) and also prints how far the
gradients through K4's kernels are from the plain ones; the noised runs
launch no kernel.

    PYTHONPATH=src python scripts/recurrent_bwd_precision.py [--sensitivity [--card]]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd.ref import CHUNK as SSD_CHUNK
from repro_torch.kernels.mamba2_ssd.ref import chunk_states as ssd_states
from repro_torch.kernels.mamba2_ssd.ref import ssd_bwd_plain
from repro_torch.kernels.rwkv6_wkv.ref import CHUNK as WKV_CHUNK
from repro_torch.kernels.rwkv6_wkv.ref import chunk_states as wkv_states
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_bwd_plain, wkv6_plain


def rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def _tf32(x, nearest):
    """x (float32) cut to TF32's 10 stored mantissa bits: rounded to
    nearest, ties away (cvt.rna.tf32), or truncated (what the tensor cores
    read of an fp32 operand)."""
    bits = x.view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def tf32x3(eq, a, b):
    """``torch.einsum(eq, a, b)`` as the backward kernels take it on tensor
    cores: each operand split as hi + lo (hi rounded to TF32, lo the rest,
    read truncated to TF32), hi*hi accumulated in fp32, the cross terms
    lo*hi + hi*lo in an fp32 accumulator of their own, the two added."""
    a, b = a.float().contiguous(), b.float().contiguous()
    ah, bh = _tf32(a, True), _tf32(b, True)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return (torch.einsum(eq, ah, bh)
            + (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)))


def wkv_steps(r, k, v, logw, u, S):
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        ys.append(torch.einsum("bhn,bhnm->bhm", rt, S)
                  + (rt * u * kt).sum(-1, keepdim=True) * vt)
        S = torch.exp(logw[:, t])[..., None] * S + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, 1), S


def ssd_steps(x, dt, A, Bm, Cm, h):
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def wkv_dlogw_anchored_once(r, k, v, logw, u, s0, dy):
    """dlogw by the reverse sums carried over the whole sequence from
    S_T . dS_T (no state cotangent: 0), T a chunk multiple."""
    B, T, H, N = r.shape
    c = WKV_CHUNK
    states = wkv_states(k, v, logw, s0)
    G = torch.zeros((B, H, N, N))
    carry = torch.zeros((B, H, N))
    tril = torch.ones((c, c), dtype=torch.bool).tril(-1)
    out = torch.empty_like(r)
    for j in reversed(range(T // c)):
        sl = slice(j * c, (j + 1) * c)
        r_, k_, v_, dy_ = r[:, sl], k[:, sl], v[:, sl], dy[:, sl]
        L = torch.cumsum(logw[:, sl], 1)
        Lp = F.pad(L[:, :-1], (0, 0, 0, 0, 1, 0))
        Lc = L[:, -1]
        D = torch.exp(torch.where(tril[None, :, :, None, None],
                                  Lp[:, :, None] - L[:, None], float("-inf")))
        Bdy = torch.where(tril[None, :, :, None],
                          torch.einsum("bthm,bshm->btsh", dy_, v_), 0.0)
        drp = (torch.einsum("btsh,btshn,bshn->bthn", Bdy, D, k_)
               + torch.exp(Lp) * torch.einsum("bhnm,bthm->bthn",
                                              states[:, :, j], dy_))
        dkp = (torch.einsum("btsh,btshn,bthn->bshn", Bdy, D, r_)
               + torch.exp(Lc[:, None] - L)
               * torch.einsum("bhnm,bshm->bshn", G, v_))
        rd, kk = r_ * drp, k_ * dkp
        rd_incl = rd.flip(1).cumsum(1).flip(1)
        kk_incl = kk.flip(1).cumsum(1).flip(1)
        out[:, sl] = (carry[:, None] + F.pad(rd_incl[:, 1:], (0, 0, 0, 0, 0, 1))
                      - kk_incl)
        carry = carry + rd_incl[:, 0] - kk_incl[:, 0]
        G = (torch.exp(Lc)[..., None] * G
             + torch.einsum("bthn,bthm->bhnm", r_ * torch.exp(Lp), dy_))
    return out


def ssd_dA_reverse_sums(x, dt, A, Bm, Cm, h0, dy, every_chunk):
    """dA by dl = anchor + reverse sums of C . dC - x . dx (per head), the
    anchor the chunk's end state against the adjoint from later chunks
    (``every_chunk``) or carried from the sequence's end; T a chunk
    multiple, no state cotangent."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    c = SSD_CHUNK
    states = ssd_states(x, dt, A, Bm, h0)
    G = torch.zeros((B, H, P, N))
    carry = torch.zeros((B, H))
    tril = torch.ones((c, c), dtype=torch.bool).tril()[None, :, :, None]
    dA = torch.zeros_like(A)
    for j in reversed(range(T // c)):
        sl = slice(j * c, (j + 1) * c)
        x_, dt_, B_, C_, dy_ = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl], dy[:, sl]
        L = torch.cumsum(dt_ * A, 1)
        Lc = L[:, -1]
        M = torch.exp(torch.where(tril, L[:, :, None] - L[:, None], float("-inf")))
        CB = torch.einsum("btn,bsn->bts", C_, B_)
        X = torch.einsum("bthp,bshp->btsh", dy_, x_)
        back = torch.exp(Lc[:, None] - L)
        dCh = (torch.exp(L)[..., None]
               * torch.einsum("bthp,bhpn->bthn", dy_, states[:, :, j])
               + torch.einsum("btsh,bsh,bsn->bthn", M * X, dt_, B_))
        gx = (back[..., None] * torch.einsum("bhpn,bsn->bshp", G, B_)
              + torch.einsum("btsh,bts,bthp->bshp", M, CB, dy_))
        w = (C_[:, :, None] * dCh).sum(-1) - dt_ * (x_ * gx).sum(-1)
        if every_chunk:
            carry = (states[:, :, j + 1] * G).sum((-1, -2))
        dl = carry[:, None] + w.flip(1).cumsum(1).flip(1)
        carry = dl[:, 0]
        dA += (dt_ * dl).sum((0, 1))
        G = (torch.exp(Lc)[..., None, None] * G
             + torch.einsum("bthp,btn->bhpn", dy_ * torch.exp(L)[..., None], C_))
    return dA


def wkv_case(name, B, T, H, N, logw_of, seed):
    g = torch.Generator().manual_seed(seed)
    d = torch.float64
    r, k, v = (torch.randn((B, T, H, N), generator=g, dtype=d) for _ in range(3))
    logw = logw_of(g, (B, T, H, N))
    u = 0.5 * torch.randn((H, N), generator=g, dtype=d)
    s0 = torch.zeros((B, H, N, N), dtype=d)
    dy = torch.randn((B, T, H, N), generator=g, dtype=d)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    y, _ = wkv_steps(*leaves)
    want = torch.autograd.grad((y * dy).sum(), leaves[3])[0]
    f32 = [t.float() for t in (r, k, v, logw, u, s0, dy)]
    port = wkv6_bwd_plain(*f32, None)[3]
    tc = wkv6_bwd_plain(*f32, None, product=tf32x3)[3]
    once = wkv_dlogw_anchored_once(*f32)
    return {"case": name, "port_every_chunk": rel(port, want),
            "port_tf32x3": rel(tc, want), "anchored_once": rel(once, want)}


def ssd_case(name, B, T, H, P, N, a_shift, seed):
    g = torch.Generator().manual_seed(seed)
    d = torch.float64
    x = torch.randn((B, T, H, P), generator=g, dtype=d)
    dt = F.softplus(torch.randn((B, T, H), generator=g, dtype=d))
    A = -torch.exp(torch.randn(H, generator=g, dtype=d) + a_shift)
    Bm, Cm = (torch.randn((B, T, N), generator=g, dtype=d) for _ in range(2))
    h0 = torch.zeros((B, H, P, N), dtype=d)
    dy = torch.randn((B, T, H, P), generator=g, dtype=d)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, h0)]
    y, _ = ssd_steps(*leaves)
    want = torch.autograd.grad((y * dy).sum(), leaves[2])[0]
    f32 = [t.float() for t in (x, dt, A, Bm, Cm, h0, dy)]
    return {"case": name, "port_term_by_term": rel(ssd_bwd_plain(*f32)[2], want),
            "reverse_sums_every_chunk": rel(ssd_dA_reverse_sums(*f32, True), want),
            "reverse_sums_once": rel(ssd_dA_reverse_sums(*f32, False), want)}


def sensitivity(layers_list, T=256, batch=1, vocab=4096, device="cpu"):
    """Each rwkv6 leaf's relative L2 move of the gradient when WKV's output
    is scaled by (1 + 1e-6 noise): rwkv6-1.6b's width, ``vocab`` (None:
    the model's), ``batch`` rows of T synthetic tokens, float32.  On a GPU
    the step is chip_smoke phase 13 C's float32 one (float32 copies of
    the bf16 init, remat on), and the move of the gradient through K4's
    kernels is printed beside it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.models import build_model
    from repro_torch.models import rwkv6 as R
    from repro_torch.training import DataConfig, SyntheticLM, train_loop
    out = {}
    cuda = device == "cuda"
    for layers in layers_list:
        cfg = dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=layers)
        if not cuda:
            cfg = dataclasses.replace(cfg, dtype="float32")
        if vocab is not None:
            cfg = dataclasses.replace(cfg, vocab_size=vocab)
        model = build_model(cfg)
        params = model.init(0, device)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=T,
                                      global_batch=batch, num_dialects=1))
        batch_t = {k: torch.as_tensor(v, device=device)
                   for k, v in data.batch_at(0).items()}

        def grads(wkv):
            R.wkv6 = wkv
            ps = {k: v.float() for k, v in params.items()}
            return train_loop._grads(model, ps, batch_t, remat=cuda)[2]

        def noised(noise):
            def wkv(*a):
                y, s = wkv6_plain(*a)
                g = torch.Generator(device=device).manual_seed(5)
                return y * (1 + noise * torch.randn(
                    y.shape, generator=g, device=device)), s
            return wkv
        kernel = R.wkv6
        wkv_ops.wkv6.launches = 0
        try:
            g0, g1 = grads(noised(0.0)), grads(noised(1e-6))
            plain_launches = wkv_ops.wkv6.launches
            gk = grads(kernel) if cuda else None
        finally:
            R.wkv6 = kernel

        def moves(g):
            m = {k: float((g[k] - g0[k]).norm()
                          / g0[k].norm().clamp(min=1e-30)) for k in g0}
            worst = max(m, key=m.get)
            return m[worst], worst
        row = dict(zip(("largest_move", "leaf"), moves(g1)),
                   grad_norm=float(sum(v.norm() ** 2
                                       for v in g0.values()) ** 0.5),
                   noised_runs_kernel_launches=plain_launches)
        if gk is not None:
            row.update(zip(("kernels_largest_move", "kernels_leaf"),
                           moves(gk)))
        out[layers] = row
        del g0, g1, gk, params, model
        if cuda:
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sensitivity", action="store_true")
    ap.add_argument("--card", action="store_true",
                    help="the sensitivity on the GPU at B=4 x 2048 tokens "
                         "and the full vocab, beside the kernels' move")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(torch.get_num_threads(), 8))

    def logw_model(g, shape):       # rwkv6's init: w0 from -6 to -0.5
        w0 = torch.linspace(-6, -0.5, shape[-2] * shape[-1],
                            dtype=torch.float64).reshape(shape[-2:])
        return -torch.exp(w0 + 0.1 * torch.randn(shape, generator=g,
                                                   dtype=torch.float64))

    def logw_shift(shift):
        return lambda g, shape: -torch.exp(
            torch.randn(shape, generator=g, dtype=torch.float64) + shift)
    WKV_FORMS = ("port_every_chunk", "port_tf32x3", "anchored_once")

    def worst(rows, keys):
        """Each form's largest error over the seeds."""
        return {k: max(r[k] for r in rows) for k in keys}
    res = [
        {"of": "wkv6_dlogw", "case": "rwkv6's init decays, T=1024",
         **worst([wkv_case("", 1, 1024, 2, 64, logw_model, s)
                  for s in range(2)], WKV_FORMS)},
        *({"of": "wkv6_dlogw", "case": f"logw = -exp(normal + {sh}), T=512",
           **worst([wkv_case("", 1, 512, 2, 16, logw_shift(sh), s)
                    for s in range(4)], WKV_FORMS)}
          for sh in (2.0, 2.5, 4.0)),
        *({"of": "ssd_dA", "case": f"A = -exp(normal + {sh}), T=512",
           **worst([ssd_case("", 1, 512, 2, 16, 8, sh, s) for s in range(8)],
                   ("port_term_by_term", "reverse_sums_every_chunk",
                    "reverse_sums_once"))}
          for sh in (0.0, 3.0))]
    print("largest error over the seeds, of the float64 gradient's largest "
          "entry", flush=True)
    for row in res:
        print(json.dumps(row), flush=True)
    if args.sensitivity:
        shape = (dict(T=2048, batch=4, vocab=None, device="cuda")
                 if args.card else {})
        of = ("B=4, T=2048, full vocab, on "
              + torch.cuda.get_device_name(0) if args.card else "T=256")
        for layers, row in sensitivity([2, 8, 24], **shape).items():
            print(json.dumps({"of": f"rwkv6 gradient sensitivity, {of}",
                              "layers": layers, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
