"""The fused block kernels' wrappers (``kernels/fused_block``): RMSNorm with
the residual add before it, RoPE on q and k, SwiGLU's ``silu(gate) * up``.

CPU cases: the model layers that call them equal the eager chain they
replaced bit for bit (written out here as the model layers had it:
yi-9b's and h2o-danube's widths, head dims 128 and 80, S = 1 ticks, (B, S)
positions, the residual form), bfloat16 calls through the wrappers and
float32 ones through the eager chain; on meta tensors the outputs have the
card's shapes and dtypes; ``layers.fused`` keeps the eager chain for
inputs that need a gradient, layernorm configs, odd head dims and other
dtypes, and the wrappers raise on meta (as on the card) for anything the
kernels cannot take (strided or misaligned tensors, other dtypes, shapes,
positions); an ``analysis.costs.Counter`` records one call a wrapper with
its cost function's bytes, and a dense bfloat16 forward 2L + 1 norms, L
ropes and L silu * up.

GPU cases (marker ``gpu``, skipped without a CUDA device): the kernels
against the plain versions on the card, RoPE and silu * up bit for bit,
the norm within one bf16 ulp, and their refusals.  They need no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.analysis import costs
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.fused_block import (rms_norm, rms_norm_plain,
                                             rope_qk, rope_qk_plain, silu_mul,
                                             silu_mul_plain)
from repro_torch.kernels.fused_block import ops
from repro_torch.models import build_model
from repro_torch.models.layers import (_rope_freqs_on, add_norm, apply_mlp,
                                       apply_norm, apply_rope, apply_rope_qk,
                                       fused)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the eager chains the model layers ran before the kernels, op for op


def eager_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale
    return y.to(x.dtype)


def eager_rope(x, positions, theta):
    hd = x.shape[-1]
    freqs = torch.from_numpy(1.0 / (theta ** (
        np.arange(0, hd, 2, dtype=np.float32) / hd))).to(x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def eager_swiglu(gate, up):
    return F.silu(gate) * up


def _randn(shape, dtype, seed, device="cpu", scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(device, dtype)


def _calls_of(counter):
    return {k: v["calls"] for k, v in counter.kernels.items()}


WIDTHS = {"yi-9b": dict(D=4096, H=32, K=4, hd=128, ff=11008),
          "h2o-danube-1.8b": dict(D=2560, H=32, K=8, hd=80, ff=6912)}
DTYPES = [torch.bfloat16, torch.float32]
# (B, S, positions): full sequences from 0, a tick per row, (B, S) offsets
SHAPES = [(2, 5, "arange"), (3, 1, "tick"), (2, 4, "rows")]


def _positions(kind, B, S):
    if kind == "arange":
        return torch.arange(S)[None, :]
    lengths = torch.tensor(([7, 130, 4095] * B)[:B], dtype=torch.int32)
    if kind == "tick":
        return lengths[:, None]
    return lengths[:, None].long() + torch.arange(S)[None, :]


def _cfg(arch, **kw):
    return dataclasses.replace(reduce_for_smoke(get_config(arch)), **kw)


# --- CPU: bit for bit against the eager chains -----------------------------


@pytest.mark.parametrize("arch", sorted(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,_", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
def test_norm_equals_eager(arch, dtype, B, S, _, residual):
    """bfloat16 through ``rms_norm`` (one call recorded), float32 through
    the eager chain (none): the same numbers either way."""
    D = WIDTHS[arch]["D"]
    x = _randn((B, S, D), dtype, 0)
    res = _randn((B, S, D), dtype, 1, scale=0.5)
    scale = 1 + _randn((D,), torch.float32, 2, scale=0.1)
    cfg = _cfg(arch, d_model=D)
    with torch.no_grad(), costs.Counter() as c:
        if residual:
            got_x, got = add_norm({"scale": scale}, x, res, cfg)
            x = x + res
            assert torch.equal(got_x, x)
        else:
            got = apply_norm({"scale": scale}, x, cfg)
    assert _calls_of(c) == ({"rms_norm": 1} if dtype == torch.bfloat16
                            else {})
    assert got.dtype == dtype
    assert torch.equal(got, eager_norm(x, scale, cfg.norm_eps))


@pytest.mark.parametrize("arch", sorted(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,kind", SHAPES)
def test_rope_equals_eager(arch, dtype, B, S, kind):
    w = WIDTHS[arch]
    q = _randn((B, S, w["H"], w["hd"]), dtype, 3)
    k = _randn((B, S, w["K"], w["hd"]), dtype, 4)
    positions = _positions(kind, B, S)
    theta = 10000.0
    want = (eager_rope(q, positions, theta), eager_rope(k, positions, theta))
    with torch.no_grad(), costs.Counter() as c:
        got = apply_rope_qk(q.clone(), k.clone(), positions, theta)
    assert _calls_of(c) == ({"rope_qk": 1} if dtype == torch.bfloat16
                            else {})
    for g, t in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, t)
    # the single-tensor form (MLA's rope slices) is the same chain
    assert torch.equal(apply_rope(q, positions, theta), want[0])


@pytest.mark.parametrize("arch", sorted(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,_", SHAPES[:2])
def test_swiglu_equals_eager(arch, dtype, B, S, _):
    ff = WIDTHS[arch]["ff"]
    gate = _randn((B, S, ff), dtype, 5, scale=3.0)
    up = _randn((B, S, ff), dtype, 6)
    with torch.no_grad():
        assert fused(ff, gate, up) == (dtype == torch.bfloat16)
        with costs.Counter() as c:
            got = silu_mul(gate, up)
    assert _calls_of(c) == {"silu_mul": 1}
    want = eager_swiglu(gate, up)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(silu_mul_plain(gate, up), want)


def test_mlp_equals_eager():
    """float32 through the eager chain, bfloat16 through ``silu_mul``."""
    cfg = _cfg("yi-9b")
    d, ff = cfg.d_model, cfg.d_ff
    for dtype in DTYPES:
        p = {"w_gate": _randn((d, ff), dtype, 7, scale=d ** -0.5),
             "w_up": _randn((d, ff), dtype, 8, scale=d ** -0.5),
             "w_down": _randn((ff, d), dtype, 9, scale=ff ** -0.5)}
        x = _randn((2, 3, d), dtype, 10)
        want = eager_swiglu(x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]
        with torch.no_grad(), costs.Counter() as c:
            assert torch.equal(apply_mlp(p, x, cfg), want)
        assert _calls_of(c) == ({"silu_mul": 1} if dtype == torch.bfloat16
                                else {})


# --- meta: the card's outputs, nothing launched ----------------------------


def _calls():
    """(name, make(device) -> args, the wrapper, its cost function's
    bytes)."""
    B, S, H, K, hd, D, ff = 2, 3, 4, 2, 80, 2560, 64

    def norm(dev):
        return (_randn((B, S, D), torch.bfloat16, 0, dev),
                torch.ones(D, device=dev), 1e-5)

    def norm_res(dev):
        return (*norm(dev), _randn((B, S, D), torch.bfloat16, 1, dev))

    def rope(dev):
        return (_randn((B, S, H, hd), torch.bfloat16, 1, dev),
                _randn((B, S, K, hd), torch.bfloat16, 2, dev),
                torch.arange(S, device=dev)[None, :],
                _rope_freqs_on(hd, 1e4, torch.device(dev)))

    def silu(dev):
        return (_randn((B, S, ff), torch.bfloat16, 3, dev),
                _randn((B, S, ff), torch.bfloat16, 4, dev))

    return [("rms_norm", norm, rms_norm,
             ops.rms_norm_cost(B * S, D, False).nbytes),
            ("rms_norm", norm_res, rms_norm,
             ops.rms_norm_cost(B * S, D, True).nbytes),
            ("rope_qk", rope, rope_qk,
             ops.rope_qk_cost(B, S, H, K, hd, S, 8).nbytes),
            ("silu_mul", silu, silu_mul,
             ops.silu_mul_cost(B * S * ff).nbytes)]


@pytest.mark.parametrize("name,make,fn,nbytes", _calls(),
                         ids=["norm", "norm_residual", "rope", "silu_mul"])
def test_meta_and_cpu_record_one_call(name, make, fn, nbytes):
    """On the CPU and on meta alike: one call recorded under the wrapper's
    name with its cost function's bytes (the plain ops kept out), the
    same output shapes and dtypes, no launch."""
    counters = (rms_norm, rope_qk, silu_mul)
    before = [f.launches for f in counters]
    seen = {}
    for dev in ("cpu", "meta"):
        args = make(dev)
        with torch.no_grad(), costs.Counter() as c:
            out = fn(*args)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        assert all(t.device.type == dev for t in outs)
        assert c.kernels == {name: {"calls": 1, "flops": 0.0,
                                    "bytes": nbytes}}
        assert c.bytes == nbytes and c.flops == 0
        seen[dev] = [(tuple(t.shape), t.dtype) for t in outs]
    assert seen["cpu"] == seen["meta"]
    assert [f.launches for f in counters] == before


def test_rope_meta_returns_its_inputs():
    """On meta (as on the card) q and k are rotated in place: the same
    tensors come back, nothing is allocated."""
    q = torch.empty((2, 3, 4, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 3, 1, 128), dtype=torch.bfloat16, device="meta")
    pos = torch.empty((2, 3), dtype=torch.int64, device="meta")
    with torch.no_grad():
        got = rope_qk(q, k, pos, _rope_freqs_on(128, 1e4,
                                                torch.device("meta")))
    assert got[0] is q and got[1] is k


# --- which calls take the kernels, and what the wrappers refuse -------------


def test_grad_keeps_the_eager_chain():
    """bfloat16 inputs that need a gradient take the eager chain in the
    model layers, unrecorded, and autograd differentiates it; the wrappers
    refuse them on meta (as on the card: the kernels have no backward);
    under no_grad the same calls take the wrappers."""
    cfg = _cfg("yi-9b", dtype="bfloat16")
    D = 64
    x = _randn((2, 3, D), torch.bfloat16, 0).requires_grad_(True)
    scale = torch.ones(D)
    q = _randn((2, 3, 4, 16), torch.bfloat16, 1).requires_grad_(True)
    k = _randn((2, 3, 2, 16), torch.bfloat16, 2)
    pos = torch.arange(3)[None]
    p_mlp = {"w_gate": _randn((D, 16), torch.bfloat16, 3),
             "w_up": _randn((D, 16), torch.bfloat16, 4),
             "w_down": _randn((16, D), torch.bfloat16, 5)}
    assert not fused(D, x, scale) and not fused(8, q, k)
    with costs.Counter() as c:
        y = apply_norm({"scale": scale}, x, cfg)
        xr, y2 = add_norm({"scale": scale}, x, x.detach(), cfg)
        qq, kk = apply_rope_qk(q, k, pos, 1e4)
        h = apply_mlp(p_mlp, x, cfg)
    assert c.kernels == {}
    assert all(t.grad_fn is not None for t in (y, xr, y2, qq, h))
    assert torch.equal(y, eager_norm(x, scale, cfg.norm_eps))
    (y.float().sum() + qq.float().sum()).backward()
    assert x.grad is not None and q.grad is not None
    meta_x = torch.empty((2, 3, D), dtype=torch.bfloat16,
                         device="meta").requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        rms_norm(meta_x, torch.ones(D, device="meta"), 1e-5)
    with pytest.raises(ValueError, match="no backward"):
        silu_mul(meta_x, meta_x.detach())
    with torch.no_grad(), costs.Counter() as c:
        assert fused(D, x, scale) and fused(8, q, k)
        apply_norm({"scale": scale}, x, cfg)
        apply_rope_qk(q.detach().clone(), k.clone(), pos, 1e4)
        apply_mlp(p_mlp, x, cfg)
    assert _calls_of(c) == {"rms_norm": 1, "rope_qk": 1, "silu_mul": 1}


@pytest.mark.parametrize("arch", ["command-r-plus-104b", "rwkv6-1.6b"])
def test_layernorm_keeps_the_eager_chain(arch):
    cfg = _cfg(arch)
    assert cfg.norm_kind == "layernorm"
    D = cfg.d_model
    p = {"scale": 1 + _randn((D,), torch.float32, 0, scale=0.1),
         "nbias": _randn((D,), torch.float32, 1, scale=0.1)}
    for dtype in (torch.float32, torch.bfloat16):
        x = _randn((2, 3, D), dtype, 2)
        with torch.no_grad(), costs.Counter() as c:
            y = apply_norm(p, x, cfg)
            x2, y2 = add_norm(p, x, x, cfg)
        assert c.kernels == {} and "rms_norm" not in c.kernels
        assert torch.equal(x2, x + x) and torch.equal(
            y2, apply_norm(p, x + x, cfg))
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        want = ((xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
                + p["nbias"]).to(dtype)
        assert torch.equal(y, want)


def _rope_args(hd=16, dtype=torch.bfloat16, S=3, dev="cpu"):
    q = _randn((2, S, 4, hd), dtype, 0, dev)
    k = _randn((2, S, 2, hd), dtype, 1, dev)
    return q, k, torch.arange(S, device=dev)[None], _rope_freqs_on(
        hd, 1e4, torch.device(dev))


def _rope_case(case, dev):
    q, k, pos, freqs = _rope_args(dev=dev)
    if case == "odd_head_dim":           # hd/2 = 6: not whole vectors
        q, k, pos, freqs = _rope_args(hd=12, dev=dev)
    elif case == "strided_head_dim":
        q, k = q[..., ::2], k[..., ::2]
        freqs = freqs[:4]
    elif case == "mla_slice":            # q's rope half of (nope | rope)
        q = _randn((2, 3, 4, 48), torch.bfloat16, 3, dev)[..., 32:]
    elif case in ("float16", "float64"):
        dt = getattr(torch, case)
        q, k = q.to(dt), k.to(dt)
    elif case == "float_positions":
        pos = pos.float()
    elif case == "positions_shape":
        pos = torch.arange(6, device=dev)[None]
    else:
        k = _randn((2, 5, 2, 16), torch.bfloat16, 4, dev)
    return q, k, pos, freqs


@pytest.mark.parametrize("case", [
    "odd_head_dim", "strided_head_dim", "mla_slice", "float16", "float64",
    "float_positions", "positions_shape", "kv_length_differs"])
def test_rope_engage_rule(case):
    """Odd head dims and other dtypes keep the eager chain in the model
    layers (the same numbers, nothing recorded); on meta, as on the card,
    ``rope_qk`` raises on every one of these rather than give way."""
    q, k, pos, freqs = _rope_case(case, "cpu")
    hd = q.shape[-1]
    if case in ("odd_head_dim", "float16", "float64"):
        assert not (hd % 2 == 0 and fused(hd // 2, q, k))
        with torch.no_grad(), costs.Counter() as c:
            got = apply_rope_qk(q, k, pos, 1e4)
        assert c.kernels == {}
        for g, t in zip(got, rope_qk_plain(q, k, pos, freqs)):
            assert torch.equal(g, t)
    q, k, pos, freqs = _rope_case(case, "meta")
    with torch.no_grad(), pytest.raises((TypeError, ValueError)):
        rope_qk(q, k, pos, freqs)


@pytest.mark.parametrize("case", ["float16", "float64", "bf16_scale",
                                  "width", "strided", "residual_dtype",
                                  "misaligned"])
def test_norm_and_silu_engage_rule(case):
    """Other dtypes and widths keep the eager chain in the model layers;
    on meta, as on the card, the wrappers raise on every one of these."""
    def make(dev):
        x = _randn((2, 3, 64), torch.bfloat16, 0, dev)
        scale, res, up = torch.ones(64, device=dev), x.clone(), x.clone()
        if case in ("float16", "float64"):
            x = res = up = x.to(getattr(torch, case))
        elif case == "bf16_scale":
            scale = scale.bfloat16()
        elif case == "width":  # D, and the element count, not a multiple of 8
            x = res = up = x[..., :61].contiguous()
            scale = scale[:61]
        elif case == "strided":
            x = res = up = _randn((2, 3, 128), torch.bfloat16, 1,
                                  dev)[..., ::2]
        elif case == "misaligned":   # contiguous, 2 bytes past a vector
            x = res = up = _randn((6 * 64 + 1,), torch.bfloat16, 1,
                                  dev)[1:].view(2, 3, 64)
        else:
            res = res.float()
        return x, scale, res, up

    x, scale, res, up = make("cpu")
    if case in ("float16", "float64", "width"):
        assert not fused(x.shape[-1], x, scale)
    cfg = _cfg("yi-9b")
    with torch.no_grad():
        assert torch.equal(
            add_norm({"scale": scale}, x, res, cfg)[1],
            rms_norm_plain(x, scale, cfg.norm_eps, residual=res)[1])
    x, scale, res, up = make("meta")
    with torch.no_grad():
        with pytest.raises((TypeError, ValueError)):
            rms_norm(x, scale, 1e-5, residual=res)
        if case not in ("bf16_scale", "residual_dtype"):
            with pytest.raises((TypeError, ValueError)):
                rms_norm(x, scale, 1e-5)
            with pytest.raises((TypeError, ValueError)):
                silu_mul(x, up)


# --- the served path's counts -------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "h2o-danube-1.8b"])
def test_dense_forward_records_each_kernel(arch):
    """A dense bfloat16 forward records 2L + 1 norms (ln1, ln2 with the
    residual add, the final norm), L ropes and L silu * up; a forward
    whose params need a gradient (training) records none, and a float32
    forward none."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    L = cfg.num_layers
    with torch.no_grad(), costs.Counter() as c:
        out = model.forward(params, {"tokens": tokens})
    assert {k: v["calls"] for k, v in c.kernels.items()
            if k != "flash_attention"} == {"rms_norm": 2 * L + 1,
                                           "rope_qk": L, "silu_mul": L}
    for v in params.values():
        v.requires_grad_(v.is_floating_point())
    with costs.Counter() as c:
        again = model.forward(params, {"tokens": tokens})
    assert set(c.kernels) == {"flash_attention"}
    assert torch.equal(out, again.detach())
    f32 = build_model(reduce_for_smoke(get_config(arch)))
    with torch.no_grad(), costs.Counter() as c:
        f32.forward(f32.init(0, "cpu"), {"tokens": tokens})
    assert set(c.kernels) == {"flash_attention"}


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def bf16_ulps(a, b):
    """The largest distance between a and b in units of b's last bf16
    place (2^(exponent - 7))."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    return float(((a - b).abs() / ulp).max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(WIDTHS))
@pytest.mark.parametrize("B,S,kind", [(16, 512, "arange"), (16, 1, "tick"),
                                      (4, 33, "rows")])
def test_kernels_match_plain_on_gpu(cuda, arch, B, S, kind):
    w = WIDTHS[arch]
    before = [f.launches for f in (rms_norm, rope_qk, silu_mul)]
    x = _randn((B, S, w["D"]), torch.bfloat16, 0, cuda)
    res = _randn((B, S, w["D"]), torch.bfloat16, 1, cuda, scale=0.5)
    scale = 1 + _randn((w["D"],), torch.float32, 2, cuda, scale=0.1)
    q = _randn((B, S, w["H"], w["hd"]), torch.bfloat16, 3, cuda)
    k = _randn((B, S, w["K"], w["hd"]), torch.bfloat16, 4, cuda)
    gate = _randn((B, S, w["ff"]), torch.bfloat16, 5, cuda, scale=3.0)
    up = _randn((B, S, w["ff"]), torch.bfloat16, 6, cuda)
    pos = _positions(kind, B, S).to(cuda) if kind != "rows" else (
        torch.arange(S, device=cuda)[None] + torch.tensor(
            [[3], [70], [4000], [0]], device=cuda))
    freqs = _rope_freqs_on(w["hd"], 1e4, cuda)
    with torch.no_grad():
        want_x, want_y = rms_norm_plain(x, scale, 1e-5, residual=res)
        got_x, got_y = rms_norm(x, scale, 1e-5, residual=res)
        want_q = eager_rope(q, pos, 1e4)
        want_k = eager_rope(k, pos, 1e4)
        got_q, got_k = rope_qk(q.clone(), k.clone(), pos, freqs)
        got_h = silu_mul(gate, up)
    torch.cuda.synchronize()
    assert [f.launches for f in (rms_norm, rope_qk, silu_mul)] == [
        n + 1 for n in before]
    assert torch.equal(got_x, want_x)
    assert bf16_ulps(got_y, want_y) <= 1.0
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)
    assert torch.equal(got_h, eager_swiglu(gate, up))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["float32", "too_wide", "misaligned"])
def test_kernels_refuse_on_gpu(cuda, case):
    """On the card a wrapper launches or raises: float32, a norm row wider
    than the kernel holds (the C entry's refusal) and a misaligned tensor
    raise, and nothing is launched."""
    D = 16392 if case == "too_wide" else 64
    if case == "misaligned":         # contiguous, 2 bytes past a vector
        x = _randn((6 * D + 1,), torch.bfloat16, 0, cuda)[1:].view(2, 3, D)
    else:
        x = _randn((2, 3, D), torch.bfloat16, 0, cuda)
    if case == "float32":
        x = x.float()
    before = rms_norm.launches
    with torch.no_grad(), pytest.raises((TypeError, ValueError,
                                         RuntimeError)):
        rms_norm(x, torch.ones(D, device=cuda), 1e-5)
    assert rms_norm.launches == before
