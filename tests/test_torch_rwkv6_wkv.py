"""The port's WKV-6 (K4) against the JAX package's.

CPU cases: the same numpy inputs through the JAX ``wkv6`` (the Pallas
kernel, interpret mode) and ``wkv6_ref`` and through the port's wrapper on
CPU tensors (its plain chunked version) and its ``wkv6_ref``: the shapes of
tests/test_kernels.py::test_wkv6 (T=50 and T=33 are not multiples of the
chunk), its extreme-decay case, a nonzero s0 and a split-in-two
continuation.  Tolerance 1e-4, tests/test_kernels.py's (the sides sum in
different orders and cut the chunks at other places).  A torch mirror of
the tensor-core kernel's blocking (8-step sub-chunks whose off-diagonal
blocks of A are products of two decay factors with exponents <= 0; the
products through an emulation of TF32 tensor-core operands) is held
against the Pallas kernel and the oracle at the same tolerance, extreme
decay included: with the three-term split it passes, with one-term TF32
it does not.  The wrapper's shape predicate is checked on CPU tensors of
the model's layout.

GPU cases (marker ``gpu``, skipped without a CUDA device): the Hopper
kernel against the plain version on the card at the same tolerance.  They
need no JAX.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_plain, wkv6_ref
from repro_torch.kernels.rwkv6_wkv.ops import tensor_core_path
from repro_torch.models.rwkv6 import rwkv_dims


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers every
    worker's torch would start a thread per core (several times the run's
    CPU time for the same results)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(2, 64, 4, 32, 16), (1, 128, 2, 64, 32), (2, 50, 3, 16, 32),
          (1, 33, 2, 32, 16)]


@pytest.fixture(scope="module")
def jax_wkv():
    """The JAX package's wkv6 (Pallas, interpret mode on the CPU), its
    oracle and jnp."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rwkv6_wkv import wkv6 as jwkv6
    from repro.kernels.rwkv6_wkv import wkv6_ref as jref
    return jwkv6, jref, jnp


def _inputs(B, T, H, N, seed=0, decay_shift=-1.0, s0_scale=0.3):
    """r, k, v, logw (B,T,H,N), u (H,N), s0 (B,H,N,N) as float32 numpy;
    ``logw = -exp(normal + decay_shift)`` (tests/test_kernels.py's)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, T, H, N)) + decay_shift)
    u = rng.standard_normal((H, N)) * 0.5
    s0 = rng.standard_normal((B, H, N, N)) * s0_scale
    return (r, k, v, logw.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32))


def _jax_oracle(jax_wkv, r, k, v, logw, u, s0):
    _, jref, jnp = jax_wkv
    y, sT = jref(*(jnp.moveaxis(jnp.asarray(t), 1, 2)
                   for t in (r, k, v, logw)), jnp.asarray(u),
                 jnp.asarray(s0))
    return np.asarray(jnp.moveaxis(y, 2, 1)), np.asarray(sT)


@pytest.mark.parametrize("B,T,H,N,chunk", SHAPES)
def test_plain_matches_pallas_and_oracles(jax_wkv, B, T, H, N, chunk):
    jwkv6, _, jnp = jax_wkv
    ins = _inputs(B, T, H, N)
    want_y, want_s = (np.asarray(a) for a in jwkv6(
        *(jnp.asarray(t) for t in ins), chunk=chunk))
    ref_y, ref_s = _jax_oracle(jax_wkv, *ins)
    before = wkv6.launches
    got_y, got_s = wkv6(*(torch.from_numpy(t) for t in ins))
    assert wkv6.launches == before                    # CPU: no launch
    assert got_y.shape == (B, T, H, N) and got_y.dtype == torch.float32
    for want in ((want_y, want_s), (ref_y, ref_s)):
        assert_allclose(got_y.numpy(), want[0], **TOL)
        assert_allclose(got_s.numpy(), want[1], **TOL)
    port_ref = wkv6_ref(*(torch.from_numpy(t) for t in ins))
    assert_allclose(port_ref[0].numpy(), ref_y, **TOL)
    assert_allclose(port_ref[1].numpy(), ref_s, **TOL)


def test_extreme_decay_is_stable(jax_wkv):
    """Strong data-dependent decay (tests/test_kernels.py::
    test_wkv6_extreme_decay_stability): no overflow, and the log-space
    chunked form still matches the step-by-step oracle."""
    B, T, H, N = 1, 64, 2, 32
    r, k, v, logw, _, _ = _inputs(B, T, H, N, seed=1, decay_shift=2.0)
    u = np.zeros((H, N), np.float32)
    s0 = np.zeros((B, H, N, N), np.float32)
    got_y, got_s = wkv6(*(torch.from_numpy(t)
                          for t in (r, k, v, logw, u, s0)))
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    ref_y, ref_s = _jax_oracle(jax_wkv, r, k, v, logw, u, s0)
    assert_allclose(got_y.numpy(), ref_y, **TOL)
    assert_allclose(got_s.numpy(), ref_s, **TOL)


def test_nonzero_s0_carries_in(jax_wkv):
    """With k = v = 0 the output is the carried state read through the
    decays alone: y_t = r_t diag(prod_{s<t} w_s) S0."""
    B, T, H, N = 2, 40, 2, 16
    r, k, v, logw, u, s0 = _inputs(B, T, H, N, seed=2, s0_scale=1.0)
    k[:] = 0.0
    v[:] = 0.0
    got_y, got_s = wkv6(*(torch.from_numpy(t)
                          for t in (r, k, v, logw, u, s0)))
    ref_y, ref_s = _jax_oracle(jax_wkv, r, k, v, logw, u, s0)
    assert np.abs(ref_y).max() > 1e-2
    assert_allclose(got_y.numpy(), ref_y, **TOL)
    assert_allclose(got_s.numpy(), ref_s, **TOL)


def test_split_in_two_equals_one_call():
    """Two calls with the state carried between them equal one call over
    the whole sequence (the continuous-batching invariant)."""
    ins = [torch.from_numpy(t) for t in _inputs(2, 70, 3, 32, seed=3)]
    r, k, v, logw, u, s0 = ins
    y, sT = wkv6(*ins)
    y1, s1 = wkv6(r[:, :45], k[:, :45], v[:, :45], logw[:, :45], u, s0)
    y2, s2 = wkv6(r[:, 45:], k[:, 45:], v[:, 45:], logw[:, 45:], u, s1)
    assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), **TOL)
    assert_allclose(s2.numpy(), sT.numpy(), **TOL)


# --- the tensor-core kernel's arithmetic, mirrored on the CPU ----------------


def tf32(a):
    """float32 rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: add half of bit 13 to
    the int32 view and clear the 13 low bits."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(a):
    """float32 truncated to TF32, as the tensor cores read an operand whose
    13 low mantissa bits are not clear."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm(a, b, terms):
    """``a @ b`` as the kernel's mma.sync takes it: ``terms=3`` splits each
    operand as hi + lo (hi rounded to TF32, lo the rest, which the tensor
    cores truncate to TF32) and sums hi*lo + lo*hi + hi*hi; ``terms=1``
    rounds each operand to TF32 once; ``terms=0`` is fp32."""
    if terms == 0:
        return a @ b
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return ah @ bh
    return (tf32_trunc(a - ah) @ bh + ah @ tf32_trunc(b - bh)) + ah @ bh


def wkv6_blocked(r, k, v, logw, u, s0, *, terms=3, c=32, sub=8):
    """The tensor-core kernel's blocking, in float32 on numpy inputs.  Per
    chunk of ``c`` steps: L the step-by-step cumulative sum of logw, Lprev
    its previous sum; for sub-chunk i (last step e) and every later step
    t, A[t, s in i] = (r_t o exp(Lprev_t - L_e)) . (k_s o exp(L_e - L_s))
    through ``mm(terms)``; the diagonal sub-blocks exact, with the bonus;
    y = [A | r o exp(Lprev)] [v ; S] and
    S' = exp(L_c) o S + (k o exp(L_c - L))^T v through ``mm(terms)``."""
    r, k, v, logw, u, S = (torch.from_numpy(t) for t in (r, k, v, logw, u,
                                                          s0))
    B, T, H, N = r.shape
    Tp = -(-T // c) * c
    r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Tp - T))
                     .transpose(1, 2) for t in (r, k, v, logw))  # (B,H,T,N)
    strict = torch.ones((sub, sub), dtype=torch.bool).tril(-1)[..., None]
    ys = []
    for j in range(Tp // c):
        sl = slice(j * c, (j + 1) * c)
        r_, k_, v_ = r[:, :, sl], k[:, :, sl], v[:, :, sl]
        L = torch.cumsum(logw[:, :, sl], dim=2)
        Lp = torch.nn.functional.pad(L[:, :, :-1], (0, 0, 1, 0))
        A = torch.zeros((B, H, c, c))
        for i in range(c // sub - 1):
            e = sub * i + sub - 1
            rows, cols = slice(e + 1, c), slice(sub * i, sub * i + sub)
            Le = L[:, :, e:e + 1]
            rt = r_[:, :, rows] * torch.exp(Lp[:, :, rows] - Le)
            kt = k_[:, :, cols] * torch.exp(Le - L[:, :, cols])
            A[:, :, rows, cols] = mm(rt, kt.transpose(-1, -2), terms)
        for d in range(c // sub):
            blk = slice(sub * d, sub * d + sub)
            diff = Lp[:, :, blk, None] - L[:, :, None, blk]  # (B,H,t,s,N)
            D = torch.exp(torch.where(strict, diff, float("-inf")))
            Ad = (r_[:, :, blk, None] * k_[:, :, None, blk] * D).sum(-1)
            bonus = (r_[:, :, blk] * u[:, None] * k_[:, :, blk]).sum(-1)
            A[:, :, blk, blk] = Ad + torch.diag_embed(bonus)
        y = mm(torch.cat([A, r_ * torch.exp(Lp)], -1),
               torch.cat([v_, S], -2), terms)
        Lc = L[:, :, -1:]
        S = (torch.exp(Lc).transpose(-1, -2) * S
             + mm((k_ * torch.exp(Lc - L)).transpose(-1, -2), v_, terms))
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, 1)[:, :T].numpy(), S.numpy()


MIRROR_CASES = [
    # B, T, H, N, decay_shift, Pallas chunk: T=45 cuts the last chunk
    # short inside a sub-chunk; decay_shift 2.0 is the extreme decay
    (2, 45, 3, 64, -1.0, 16),
    (1, 64, 2, 32, 2.0, 16),
]


@pytest.mark.parametrize("B,T,H,N,decay_shift,chunk", MIRROR_CASES)
def test_blocked_mirror_matches_pallas_and_oracle(jax_wkv, B, T, H, N,
                                                  decay_shift, chunk):
    """The kernel's sub-chunk blocking at chunk 32, with the three-term
    TF32 split and in fp32, against the Pallas kernel (interpret mode, at
    the chunk tests/test_kernels.py runs it) and the JAX oracle."""
    jwkv6, _, jnp = jax_wkv
    ins = _inputs(B, T, H, N, seed=5, decay_shift=decay_shift)
    want = [np.asarray(a) for a in jwkv6(*(jnp.asarray(t) for t in ins),
                                         chunk=chunk)]
    oracle = _jax_oracle(jax_wkv, *ins)
    for terms in (3, 0):
        got = wkv6_blocked(*ins, terms=terms)
        assert all(np.isfinite(g).all() for g in got)
        for ref in (want, oracle):
            assert_allclose(got[0], ref[0], **TOL)
            assert_allclose(got[1], ref[1], **TOL)


def test_one_term_tf32_misses_the_tolerance(jax_wkv):
    """The reason for the split: on the same inputs, TF32 operands rounded
    once put y outside 1e-4 of the oracle, the three-term split inside."""
    ins = _inputs(2, 45, 3, 64, seed=5)
    oracle = _jax_oracle(jax_wkv, *ins)
    err = {}
    for terms in (1, 3):
        got = wkv6_blocked(*ins, terms=terms)
        err[terms] = float((np.abs(got[0] - oracle[0])
                            / (1e-4 + 1e-4 * np.abs(oracle[0]))).max())
    assert err[3] < 1.0 < err[1], err       # in units of the tolerance
    assert err[1] > 10 * err[3], err


def test_tensor_core_predicate_takes_the_model_shapes():
    """rwkv6-1.6b's shapes (N = 64, r/k/v/logw reshaped from float32
    projections) take the tensor-core kernel, also as views of one packed
    tensor; the reduced config's (N = 32) and an unaligned view take the
    CUDA-core kernel."""
    full = get_config("rwkv6-1.6b")
    H, N = rwkv_dims(full)
    assert N == 64
    t = torch.zeros((2, 5, H * N)).reshape(2, 5, H, N)
    assert tensor_core_path(t, t, t, t)
    packed = torch.zeros((2, 5, H, 4 * N)).split(N, dim=-1)
    assert tensor_core_path(*packed)
    H2, N2 = rwkv_dims(reduce_for_smoke(full))
    small = torch.zeros((2, 5, H2, N2))
    assert not tensor_core_path(small, small, small, small)
    shifted = torch.zeros(t.numel() + 1)[1:].view(t.shape)
    assert not tensor_core_path(t, shifted, t, t)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # B, T, H, N, decay_shift, strided; N = 64 takes the tensor-core kernel
    (8, 512, 32, 64, -1.0, False),      # the rwkv6-1.6b prefill bucket
    (2, 300, 4, 64, -1.0, False),
    (3, 17, 4, 64, -1.0, True),
    (2, 50, 3, 16, -1.0, False),
    (1, 33, 2, 32, -1.0, True),
    (1, 64, 2, 32, 2.0, False),         # extreme decay
    (2, 45, 3, 64, -1.0, False),        # T not a multiple of 8 or 32
    (1, 5, 2, 64, -1.0, True),          # T shorter than one sub-chunk
    (2, 77, 4, 64, 2.0, True),          # extreme decay on tensor cores
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,N,decay_shift,strided", GPU_CASES)
def test_kernel_matches_plain_on_gpu(cuda, B, T, H, N, decay_shift,
                                     strided):
    ins = [torch.from_numpy(t).to(cuda)
           for t in _inputs(B, T, H, N, decay_shift=decay_shift)]
    if strided:     # r, k, v, logw as views of one (B,T,H,4N) tensor
        packed = torch.cat(ins[:4], dim=-1)
        ins[:4] = packed.split(N, dim=-1)
    before = wkv6.launches
    got = wkv6(*ins)
    want = wkv6_plain(*ins)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


@pytest.mark.gpu
def test_kernel_continuation_and_masked_steps_on_gpu(cuda):
    """Two kernel calls carry the state like one; masked steps (k=v=0,
    logw=0) leave it unchanged."""
    r, k, v, logw, u, s0 = (torch.from_numpy(t).to(cuda)
                            for t in _inputs(2, 100, 4, 64, seed=4))
    y, sT = wkv6(r, k, v, logw, u, s0)
    y1, s1 = wkv6(r[:, :37], k[:, :37], v[:, :37], logw[:, :37], u, s0)
    y2, s2 = wkv6(r[:, 37:], k[:, 37:], v[:, 37:], logw[:, 37:], u, s1)
    assert_allclose(torch.cat([y1, y2], 1).cpu().numpy(), y.cpu().numpy(),
                    **TOL)
    assert_allclose(s2.cpu().numpy(), sT.cpu().numpy(), **TOL)
    m = torch.ones((2, 100, 1, 1), device=cuda)
    m[1, 60:] = 0.0
    _, sm = wkv6(r, k * m, v * m, logw * m, u, s0)
    _, s60 = wkv6(r[1:, :60], k[1:, :60], v[1:, :60], logw[1:, :60], u,
                  s0[1:])
    assert_allclose(sm[1:].cpu().numpy(), s60.cpu().numpy(), **TOL)


@pytest.mark.gpu
def test_unaligned_rows_take_the_cuda_core_kernel_on_gpu(cuda):
    """N = 64 with r 4 bytes off a 16-byte boundary takes the CUDA-core
    kernel, and it matches too."""
    ins = [torch.from_numpy(t).to(cuda) for t in _inputs(2, 70, 3, 64,
                                                          seed=6)]
    r = torch.empty(ins[0].numel() + 1, device=cuda)[1:].view(ins[0].shape)
    ins[0] = r.copy_(ins[0])
    assert not tensor_core_path(*ins[:4])
    got, want = wkv6(*ins), wkv6_plain(*ins)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((1, 4, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        wkv6(x, x, x, x, torch.zeros((2, 128), device=cuda),
             torch.zeros((1, 2, 128, 128), device=cuda))
    x = torch.zeros((1, 4, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="s0"):
        wkv6(x, x, x, x, torch.zeros((2, 16), device=cuda),
             torch.zeros((1, 2, 16, 8), device=cuda))
