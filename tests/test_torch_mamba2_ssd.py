"""The port's Mamba-2 SSD scan (K5) against the JAX package's.

CPU cases: the same numpy inputs through the JAX ``ssd`` (the Pallas
kernel, interpret mode) and ``ssd_ref`` and through the port's wrapper on
CPU tensors (its plain chunked version) and its ``ssd_ref``: the three
shapes of tests/test_kernels.py::test_ssd (T=100 is not a multiple of the
chunk), with its tolerance of 1e-4 on y scaled by max|y| + 1 (y grows with
T; the sides sum in different orders and cut the chunks at other places)
and 1e-4 on the state; dt=0 pad steps, a nonzero h0 and a split-in-two
continuation.

GPU cases (marker ``gpu``, skipped without a CUDA device): the Hopper
kernel against the plain version on the card at the same tolerances.
They need no JAX.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.kernels.mamba2_ssd import ssd, ssd_plain, ssd_ref
from repro_torch.kernels.mamba2_ssd.ops import tensor_core_path
from repro_torch.models.mamba2 import mamba2_dims


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
SHAPES = [(2, 64, 4, 32, 16, 16), (1, 128, 2, 64, 64, 32),
          (2, 100, 3, 16, 32, 64)]


@pytest.fixture(scope="module")
def jax_ssd():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.mamba2_ssd import ssd as jssd
    from repro.kernels.mamba2_ssd import ssd_ref as jref
    return jssd, jref, jnp


def _inputs(B, T, H, P, N, seed=0, h0_scale=0.3):
    """x (B,T,H,P), dt = softplus(normal) (B,T,H), A = -exp(normal) (H,),
    Bm/Cm (B,T,N), h0 (B,H,P,N): float32 numpy, tests/test_kernels.py's
    distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H))))
    A = -np.exp(rng.standard_normal((H,)))
    Bm = rng.standard_normal((B, T, N))
    Cm = rng.standard_normal((B, T, N))
    h0 = rng.standard_normal((B, H, P, N)) * h0_scale
    return tuple(a.astype(np.float32) for a in (x, dt, A, Bm, Cm, h0))


def _close(got, want):
    """tests/test_kernels.py::test_ssd's comparison."""
    scale = float(np.abs(want[0]).max()) + 1.0
    assert_allclose(got[0] / scale, want[0] / scale, **TOL)
    assert_allclose(got[1], want[1], **TOL)


def _np(pair):
    return tuple(np.asarray(a) for a in pair)


@pytest.mark.parametrize("B,T,H,P,N,chunk", SHAPES)
def test_plain_matches_pallas_and_oracles(jax_ssd, B, T, H, P, N, chunk):
    jssd, jref, jnp = jax_ssd
    ins = _inputs(B, T, H, P, N)
    want = _np(jssd(*(jnp.asarray(t) for t in ins), chunk=chunk))
    oracle = _np(jref(*(jnp.asarray(t) for t in ins)))
    before = ssd.launches
    got = ssd(*(torch.from_numpy(t) for t in ins))
    assert ssd.launches == before                      # CPU: no launch
    assert got[0].shape == (B, T, H, P) and got[0].dtype == torch.float32
    _close(_np(t.numpy() for t in got), want)
    _close(_np(t.numpy() for t in got), oracle)
    _close(_np(t.numpy() for t in ssd_ref(*(torch.from_numpy(t)
                                            for t in ins))), oracle)


def test_dt_zero_steps_leave_the_state(jax_ssd):
    """Pad steps (dt = 0, the ragged prefill's mask) neither decay nor
    feed the state: it equals the state of the unpadded prefix."""
    x, dt, A, Bm, Cm, h0 = _inputs(2, 90, 3, 16, 16, seed=1, h0_scale=1.0)
    dt[1, 40:] = 0.0
    got = ssd(*(torch.from_numpy(t) for t in (x, dt, A, Bm, Cm, h0)))
    short = ssd(*(torch.from_numpy(t) for t in (
        x[1:, :40], dt[1:, :40], A, Bm[1:, :40], Cm[1:, :40], h0[1:])))
    assert_allclose(got[1][1:].numpy(), short[1].numpy(), **TOL)
    _, jref, jnp = jax_ssd
    _close(_np(t.numpy() for t in got),
           _np(jref(*(jnp.asarray(t) for t in (x, dt, A, Bm, Cm, h0)))))


def test_state_continuation():
    """Two calls with the state carried between them equal one call
    (tests/test_kernels.py::test_ssd_state_continuation, with a nonzero
    h0 and a cut inside a chunk)."""
    ins = [torch.from_numpy(t) for t in _inputs(1, 150, 2, 16, 16, seed=2)]
    x, dt, A, Bm, Cm, h0 = ins
    y, hT = ssd(*ins)
    y1, h1 = ssd(x[:, :70], dt[:, :70], A, Bm[:, :70], Cm[:, :70], h0)
    y2, h2 = ssd(x[:, 70:], dt[:, 70:], A, Bm[:, 70:], Cm[:, 70:], h1)
    _close((torch.cat([y1, y2], 1).numpy(), h2.numpy()),
           (y.numpy(), hT.numpy()))


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


def ssd_blocked(x, dt, A, Bm, Cm, h0, *, terms=3, c=32):
    """The tensor-core kernel's blocking, in float32 on numpy inputs: per
    chunk of ``c`` steps G = C B^T once per batch row (shared by every
    head), W = exp(min(L_t - L_s, 0)) o G for s <= t,
    y = [W | exp(L) o C] [x dt ; h^T] and
    h' = exp(L_c) h + ((x dt) o exp(min(L_c - L, 0)))^T B, each product
    through ``mm(terms)``."""
    x, dt, A, Bm, Cm, h = (torch.from_numpy(t) for t in (x, dt, A, Bm, Cm,
                                                          h0))
    Bt, T, H, P = x.shape
    Tp = -(-T // c) * c
    pad = Tp - T
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
    lower = torch.ones((c, c), dtype=torch.bool).tril()
    ys = []
    for j in range(Tp // c):
        sl = slice(j * c, (j + 1) * c)
        B_, C_ = Bm[:, sl], Cm[:, sl]                          # (B,c,N)
        G = C_ @ B_.transpose(1, 2)                            # (B,c,c)
        L = torch.cumsum(dt[:, sl] * A, dim=1).transpose(1, 2)  # (B,H,c)
        diff = torch.where(lower, L[..., :, None] - L[..., None, :],
                           float("-inf"))
        W = torch.exp(diff.clamp(max=0.0)) * G[:, None]         # (B,H,c,c)
        xd = (x[:, sl] * dt[:, sl, :, None]).transpose(1, 2)   # (B,H,c,P)
        eLC = torch.exp(L)[..., None] * C_[:, None]            # (B,H,c,N)
        y = mm(torch.cat([W, eLC], -1),
               torch.cat([xd, h.transpose(-1, -2)], -2), terms)
        wd = torch.exp((L[..., -1:] - L).clamp(max=0.0))
        h = (torch.exp(L[..., -1])[..., None, None] * h
             + mm((xd * wd[..., None]).transpose(-1, -2), B_[:, None],
                  terms))
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, 1)[:, :T].numpy(), h.numpy()


MIRROR_CASES = [
    # B, T, H, P, N, Pallas chunk: T=70 cuts the last chunk short
    (2, 70, 3, 64, 64, 16),
    (1, 64, 2, 32, 16, 16),
]


@pytest.mark.parametrize("B,T,H,P,N,chunk", MIRROR_CASES)
def test_blocked_mirror_matches_pallas_and_oracle(jax_ssd, B, T, H, P, N,
                                                  chunk):
    """The kernel's blocking with the three-term TF32 split and in fp32
    against the Pallas kernel (interpret mode) and the JAX oracle."""
    jssd, jref, jnp = jax_ssd
    ins = _inputs(B, T, H, P, N, seed=5)
    want = _np(jssd(*(jnp.asarray(t) for t in ins), chunk=chunk))
    oracle = _np(jref(*(jnp.asarray(t) for t in ins)))
    for terms in (3, 0):
        got = ssd_blocked(*ins, terms=terms)
        _close(got, want)
        _close(got, oracle)


def test_one_term_tf32_misses_the_tolerance(jax_ssd):
    """The reason for the split: on the same inputs, TF32 operands rounded
    once put y outside 1e-4 of the oracle, the three-term split inside."""
    _, jref, jnp = jax_ssd
    ins = _inputs(2, 70, 3, 64, 64, seed=5)
    oracle = _np(jref(*(jnp.asarray(t) for t in ins)))
    scale = float(np.abs(oracle[0]).max()) + 1.0
    err = {terms: float(np.abs(ssd_blocked(*ins, terms=terms)[0]
                               - oracle[0]).max()) / scale
           for terms in (1, 3)}
    assert err[3] < 1e-4 < err[1], err
    assert err[1] > 10 * err[3], err


def test_tf32_rounding_and_truncation_at_bit_13():
    a = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -12],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -9), 1.0]
    assert tf32(a).tolist() == want
    assert tf32_trunc(a).tolist() == [1.0, 1.0, -(1.0 + 2.0 ** -10), 1.0]


def _model_views(cfg, B=2, T=5):
    """x, Bm, Cm in the layout mamba2.py passes them: views of one float32
    conv output (B, T, inner + 2N), x reshaped to (B,T,H,P)."""
    inner, H, P, N = mamba2_dims(cfg)
    conv = torch.zeros((B, T, inner + 2 * N))
    x, Bm, Cm = torch.split(conv, [inner, N, N], dim=-1)
    return x.reshape(B, T, H, P), Bm, Cm


def test_tensor_core_predicate_takes_the_model_shapes():
    """zamba2-2.7b's shapes (P = N = 64) take the tensor-core kernel, as
    views of the conv output and as the contiguous copies ``.float()``
    makes of bf16; the reduced config's (P=32, N=16), an unaligned view
    and a row stride that is not a multiple of 4 floats take the
    CUDA-core kernel."""
    full = get_config("zamba2-2.7b")
    x, Bm, Cm = _model_views(full)
    assert x.shape[-1] == Bm.shape[-1] == 64
    assert tensor_core_path(x, Bm, Cm)
    assert tensor_core_path(x.contiguous(), Bm.contiguous(), Cm.contiguous())
    assert not tensor_core_path(*_model_views(reduce_for_smoke(full)))
    flat = torch.zeros(x.numel() + 1)
    shifted = flat[1:].view(x.shape)
    assert not tensor_core_path(shifted, Bm, Cm)
    odd = torch.zeros((2, 5, 66))[..., :64]                 # row stride 66
    assert not tensor_core_path(x, odd, Cm)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # B, T, H, P, N, strided; P = N = 64 takes the tensor-core kernel
    (8, 512, 80, 64, 64, False),        # the zamba2-2.7b prefill bucket
    (2, 300, 8, 64, 64, True),
    (2, 64, 4, 32, 16, False),
    (1, 128, 2, 64, 64, True),
    (2, 100, 3, 16, 32, False),
    (2, 45, 3, 64, 64, False),          # T not a multiple of the chunk
    (1, 5, 2, 64, 64, True),            # T shorter than one chunk
    (3, 33, 5, 64, 64, True),           # one step past a chunk
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,P,N,strided", GPU_CASES)
def test_kernel_matches_plain_on_gpu(cuda, B, T, H, P, N, strided):
    ins = [torch.from_numpy(t).to(cuda) for t in _inputs(B, T, H, P, N)]
    if strided:     # x, Bm, Cm as views of one conv output, as the model's
        x, dt, A, Bm, Cm, h0 = ins
        conv = torch.cat([x.reshape(B, T, H * P), Bm, Cm], dim=-1)
        xv, Bv, Cv = conv.split([H * P, N, N], dim=-1)
        ins = [xv.reshape(B, T, H, P), dt, A, Bv, Cv, h0]
    before = ssd.launches
    got = ssd(*ins)
    want = ssd_plain(*ins)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    _close(_np(g.cpu().numpy() for g in got),
           _np(w.cpu().numpy() for w in want))


@pytest.mark.gpu
def test_kernel_continuation_and_dt_zero_on_gpu(cuda):
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(t).to(cuda)
                            for t in _inputs(2, 200, 8, 64, 64, seed=3))
    y, hT = ssd(x, dt, A, Bm, Cm, h0)
    y1, h1 = ssd(x[:, :77], dt[:, :77], A, Bm[:, :77], Cm[:, :77], h0)
    y2, h2 = ssd(x[:, 77:], dt[:, 77:], A, Bm[:, 77:], Cm[:, 77:], h1)
    _close((torch.cat([y1, y2], 1).cpu().numpy(), h2.cpu().numpy()),
           (y.cpu().numpy(), hT.cpu().numpy()))
    dtm = dt.clone()
    dtm[1, 120:] = 0.0
    _, hm = ssd(x, dtm, A, Bm, Cm, h0)
    _, h120 = ssd(x[1:, :120], dt[1:, :120], A, Bm[1:, :120], Cm[1:, :120],
                  h0[1:])
    assert_allclose(hm[1:].cpu().numpy(), h120.cpu().numpy(), **TOL)


@pytest.mark.gpu
def test_unaligned_rows_take_the_cuda_core_kernel_on_gpu(cuda):
    """P = N = 64 with x 4 bytes off a 16-byte boundary, or Bm rows 66
    floats apart, take the CUDA-core kernel, and it matches too."""
    ins = [torch.from_numpy(t).to(cuda) for t in _inputs(2, 70, 3, 64, 64,
                                                          seed=4)]
    x = torch.empty(ins[0].numel() + 1, device=cuda)[1:].view(ins[0].shape)
    x.copy_(ins[0])
    Bv = torch.nn.functional.pad(ins[3], (0, 2))[..., :64]
    for case in ([x, *ins[1:]], [ins[0], ins[1], ins[2], Bv, *ins[4:]]):
        assert not tensor_core_path(case[0], case[3], case[4])
        got, want = ssd(*case), ssd_plain(*case)
        torch.cuda.synchronize()
        _close(_np(g.cpu().numpy() for g in got),
               _np(w.cpu().numpy() for w in want))


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((1, 4, 2, 128), device=cuda)
    dt = torch.zeros((1, 4, 2), device=cuda)
    A = torch.zeros((2,), device=cuda)
    Bm = torch.zeros((1, 4, 16), device=cuda)
    with pytest.raises(ValueError, match="P, N <= 64"):
        ssd(x, dt, A, Bm, Bm, torch.zeros((1, 2, 128, 16), device=cuda))
    with pytest.raises(ValueError, match="shape mismatch"):
        ssd(x[..., :16], dt, A, Bm, Bm, torch.zeros((1, 2, 16, 8),
                                                     device=cuda))
