"""The port's WKV-6 (K4) against the JAX package's.

CPU cases: the same numpy inputs through the JAX ``wkv6`` (the Pallas
kernel, interpret mode) and ``wkv6_ref`` and through the port's wrapper on
CPU tensors (its plain chunked version) and its ``wkv6_ref``: the shapes of
tests/test_kernels.py::test_wkv6 (T=50 and T=33 are not multiples of the
chunk), its extreme-decay case, a nonzero s0 and a split-in-two
continuation.  Tolerance 1e-4, tests/test_kernels.py's (the sides sum in
different orders and cut the chunks at other places).

GPU cases (marker ``gpu``, skipped without a CUDA device): the Hopper
kernel against the plain version on the card at the same tolerance.  They
need no JAX.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_plain, wkv6_ref

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


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # B, T, H, N, decay_shift, strided
    (8, 512, 32, 64, -1.0, False),      # the rwkv6-1.6b prefill bucket
    (2, 300, 4, 64, -1.0, False),
    (3, 17, 4, 64, -1.0, True),
    (2, 50, 3, 16, -1.0, False),
    (1, 33, 2, 32, -1.0, True),
    (1, 64, 2, 32, 2.0, False),         # extreme decay
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
def test_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((1, 4, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        wkv6(x, x, x, x, torch.zeros((2, 128), device=cuda),
             torch.zeros((1, 2, 128, 128), device=cuda))
    x = torch.zeros((1, 4, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="s0"):
        wkv6(x, x, x, x, torch.zeros((2, 16), device=cuda),
             torch.zeros((1, 2, 16, 8), device=cuda))
