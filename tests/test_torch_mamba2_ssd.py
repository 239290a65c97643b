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

from repro_torch.kernels.mamba2_ssd import ssd, ssd_plain, ssd_ref

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


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # B, T, H, P, N, strided
    (8, 512, 80, 64, 64, False),        # the zamba2-2.7b prefill bucket
    (2, 300, 8, 64, 64, True),
    (2, 64, 4, 32, 16, False),
    (1, 128, 2, 64, 64, True),
    (2, 100, 3, 16, 32, False),
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
