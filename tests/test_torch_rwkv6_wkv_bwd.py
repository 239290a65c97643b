"""The gradient of the port's WKV-6 (K4) against the JAX package's.

CPU cases: seeded numpy inputs and random cotangents for both outputs (y
and s_T) through ``jax.vjp`` of ``repro.models.rwkv6.wkv_chunked`` (the
jnp path the JAX package trains through) and through the port: autograd
of ``wkv6_plain`` and ``wkv6_bwd_plain`` (the backward kernels' formula
in their factoring: the states and adjoints at the chunk boundaries by
two scans, then every chunk's terms at once, A, dr' and dk' between
sub-chunks through factored decays).  Tolerance: 1e-4 relative to each leaf's
largest entry (the sides cut the sequence into other chunks and sum in
other orders; the reverse sums of dlogw cancel large terms).  Under strong
decay JAX's ``wkv_chunked`` takes ``exp(Lprev - L)`` before masking it,
which overflows for s >= t, and its vjp turns the masked infinities into
NaN in dr, dk and dlogw while its forward stays finite; there the port is
held against autograd of the step-by-step ``wkv6_ref`` instead.  The
wrapper's autograd route (``Wkv6Fn``, taken on CUDA tensors that require
a gradient) is shown on CPU tensors posing as CUDA ones, its launches
swapped for the plain versions.  Two checks of the factoring itself, in
float64: the sub-chunk-factored A, dr' and dk' equal the direct form over
the (t, s, n) decay tensor under strong decay, and the adjoint scan's
entries equal the step-by-step adjoint at every chunk boundary (entry 0
is ds0).

GPU cases (marker ``gpu``, skipped without a CUDA device): the backward
kernels against ``wkv6_bwd_plain`` on the card at 1e-4 of each leaf's
largest entry, bit for bit across two calls (the model's N on the
tensor-core route across 10 chunks and in one, a small N and an
unaligned r on the CUDA-core route), and autograd on CUDA tensors
through ``Wkv6Fn``.  They need no JAX.
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from repro_torch.kernels.rwkv6_wkv import ops, ref
from repro_torch.kernels.rwkv6_wkv import (wkv6, wkv6_bwd, wkv6_bwd_plain,
                                           wkv6_plain, wkv6_ref)

REL = 1e-4          # of each leaf's largest entry
NAMES = ("r", "k", "v", "logw", "u", "s0")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers small eager
    ops slow down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, H, N, seed=0, decay_shift=-1.0, s0_scale=0.3):
    """r, k, v, logw, u, s0 and the cotangents dy, dsT, float32 numpy;
    ``logw = -exp(normal + decay_shift)`` (tests/test_kernels.py's)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, T, H, N)) + decay_shift)
    u = 0.5 * rng.standard_normal((H, N))
    s0 = s0_scale * rng.standard_normal((B, H, N, N))
    dy = rng.standard_normal((B, T, H, N))
    dsT = rng.standard_normal((B, H, N, N))
    return [r, k, v, logw.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32), dy.astype(np.float32),
            dsT.astype(np.float32)]


def _check(got, want, names=NAMES):
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= REL * scale, f"{name}: {err:.3e} > {REL} x {scale:.3e}"


@pytest.fixture(scope="module")
def jax_vjp():
    """``jax.vjp`` of the JAX model's ``wkv_chunked``: (inputs, dy, dsT,
    chunk) -> (y, s_T, the six gradients) as numpy."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models.rwkv6 import wkv_chunked

    def run(ins, dy, dsT, chunk):
        out, vjp = jax.vjp(lambda *a: wkv_chunked(*a, chunk=chunk),
                           *(jnp.asarray(t) for t in ins))
        grads = vjp((jnp.asarray(dy), jnp.asarray(dsT)))
        return [np.asarray(t) for t in (*out, *grads)]
    return run


def _autograd(fn, ins, dy, dsT):
    """The six gradients of ``fn``'s (y, s_T) by autograd."""
    xs = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    y, sT = fn(*xs)
    loss = (y * torch.from_numpy(dy)).sum() + (sT * torch.from_numpy(dsT)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


# (B, T, H, N, JAX chunk, s0 scale, seed): a chunk boundary of the port's
# 32-step chunks inside the sequence, T not a multiple of it, small N, a
# zero s0
CASES = [(2, 64, 2, 16, 16, 0.3, 0), (1, 40, 3, 8, 8, 0.3, 1),
         (2, 48, 2, 32, 16, 0.0, 2)]


@pytest.mark.parametrize("B,T,H,N,chunk,s0_scale,seed", CASES)
def test_plain_backward_matches_jax_vjp(jax_vjp, B, T, H, N, chunk,
                                        s0_scale, seed):
    *ins, dy, dsT = _inputs(B, T, H, N, seed=seed, s0_scale=s0_scale)
    want = jax_vjp(ins, dy, dsT, chunk)
    got = wkv6_bwd(*(torch.from_numpy(t) for t in (*ins, dy, dsT)))
    _check(got, want[2:])


@pytest.mark.parametrize("B,T,H,N,chunk,s0_scale,seed", CASES)
def test_autograd_of_plain_matches_jax_vjp(jax_vjp, B, T, H, N, chunk,
                                           s0_scale, seed):
    *ins, dy, dsT = _inputs(B, T, H, N, seed=seed, s0_scale=s0_scale)
    want = jax_vjp(ins, dy, dsT, chunk)
    _check(_autograd(wkv6_plain, ins, dy, dsT), want[2:])


def test_without_a_state_cotangent(jax_vjp):
    """dsT = None (the model drops s_T) is a zero cotangent."""
    *ins, dy, dsT = _inputs(2, 32, 2, 16, seed=3)
    want = jax_vjp(ins, dy, np.zeros_like(dsT), 16)
    got = wkv6_bwd_plain(*(torch.from_numpy(t) for t in (*ins, dy)), None)
    _check(got, want[2:])


def test_strong_decay_against_the_step_oracle(jax_vjp):
    """logw = -exp(normal + 2): JAX's vjp is not finite (its forward is);
    the port's backward matches autograd of the step-by-step recurrence."""
    *ins, dy, dsT = _inputs(1, 64, 2, 16, seed=4, decay_shift=2.0)
    jax_out = jax_vjp(ins, dy, dsT, 16)
    assert np.isfinite(jax_out[0]).all() and np.isfinite(jax_out[1]).all()
    assert not all(np.isfinite(g).all() for g in jax_out[2:])
    want = _autograd(wkv6_ref, ins, dy, dsT)
    got = wkv6_bwd_plain(*(torch.from_numpy(t) for t in (*ins, dy, dsT)))
    _check(got, want)
    _check(_autograd(wkv6_plain, ins, dy, dsT), want)


def _chunked(ins, c=ref.CHUNK):
    """r, k, logw (B,T,H,N) float64, T a chunk multiple, as (B, nc, c, H,
    N), with the inclusive and exclusive cumulative log decays."""
    r, k, logw = (torch.from_numpy(t).double() for t in ins)
    B, T, H, N = r.shape
    r, k, logw = (t.reshape(B, T // c, c, H, N) for t in (r, k, logw))
    L = torch.cumsum(logw, dim=2)
    return r, k, L, F.pad(L[:, :, :-1], (0, 0, 0, 0, 1, 0))


def test_subchunk_factoring_equals_the_direct_form():
    """Under strong decay (logw = -exp(normal + 2), whole chunks' decays
    far past exp(-88)) the kernels' factoring of A, dr' and dk' (pairs
    of different sub-chunks through exp(Lprev_t - L_b) exp(L_b - L_s),
    pairs of one sub-chunk exact) equals the direct form over the (t, s,
    n) decay tensor D = exp(Lprev_t - L_s), s < t."""
    r, k, v, logw, u, s0, dy, dsT = _inputs(2, 64, 2, 16, seed=8,
                                           decay_shift=2.0)
    r, k, L, Lp = _chunked((r, k, logw))
    g = np.random.default_rng(9)
    Bd = torch.from_numpy(g.standard_normal((2, 2, 32, 32, 2)))
    tril = torch.ones((32, 32), dtype=torch.bool).tril(-1)
    D = torch.exp(torch.where(tril[:, :, None, None],
                              Lp[:, :, :, None] - L[:, :, None],
                              float("-inf")))          # (B,nc,t,s,H,N)
    want = ((r[:, :, :, None] * D * k[:, :, None]).sum(-1),
            torch.einsum("bjtsh,bjtshn,bjshn->bjthn", Bd, D, k),
            torch.einsum("bjtsh,bjtshn,bjthn->bjshn", Bd, D, r))
    off = ref.subchunk_terms(r, k, L, Lp, Bd)
    diag = ref.diag_terms(r, k, L, Lp, Bd)
    for name, a, b, w in zip(("A", "dr'", "dk'"), off, diag, want):
        got = a + b
        assert torch.isfinite(got).all(), name
        err = float((got - w).abs().max() / w.abs().max())
        assert err <= 1e-12, f"{name}: {err:.2e}"
    # in float32 as the kernels take it: finite, no exponent above 0
    f32 = [t.float() for t in (r, k, L, Lp, Bd)]
    assert all(torch.isfinite(t).all() for t in ref.subchunk_terms(*f32))


def test_adjoint_scan_matches_the_step_by_step_adjoint():
    """``chunk_adjoints``' entry j is the adjoint of the state at chunk j's
    start, dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T stepped back from dS_T =
    dsT one step at a time (float64): entry 0 is ds0, entry nc is dsT."""
    B, T, H, N = 2, 96, 2, 8
    r, _, _, logw, _, _, dy, dsT = (torch.from_numpy(t).double()
                                    for t in _inputs(B, T, H, N, seed=10))
    adj = ref.chunk_adjoints(r, logw, dy, dsT)
    assert adj.shape == (B, H, T // ref.CHUNK + 1, N, N)
    G = dsT
    for t in reversed(range(T)):
        if (t + 1) % ref.CHUNK == 0:
            j = (t + 1) // ref.CHUNK
            assert torch.allclose(adj[:, :, j], G, rtol=1e-12, atol=1e-12), j
        G = (torch.exp(logw[:, t])[..., None] * G
             + r[:, t, :, :, None] * dy[:, t, :, None, :])
    assert torch.allclose(adj[:, :, 0], G, rtol=1e-12, atol=1e-12)
    ds0 = wkv6_bwd_plain(*(torch.from_numpy(t) for t in _inputs(
        B, T, H, N, seed=10)))[5]
    assert torch.allclose(ds0.double(), G, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s0_grad", [True, False])
def test_cuda_tensors_take_the_autograd_function(monkeypatch, s0_grad):
    """On CUDA tensors that require a gradient, ``wkv6`` goes through
    ``Wkv6Fn`` (no refusal): shown on CPU tensors posing as CUDA ones,
    the forward launch and the backward swapped for the plain versions.
    Its gradients are autograd's of the plain version, s0's None where s0
    needs none."""
    calls = []

    def fwd(*a):
        calls.append("forward")
        return wkv6_plain(*a)

    def bwd(*a):
        calls.append("backward")
        return wkv6_bwd_plain(*a)
    monkeypatch.setattr(ops, "is_cuda", lambda *t: True)
    monkeypatch.setattr(ops, "_forward", fwd)
    monkeypatch.setattr(ops, "wkv6_bwd", bwd)
    *ins, dy, dsT = _inputs(2, 40, 2, 8, seed=5)
    xs = [torch.from_numpy(t).requires_grad_(s0_grad or i < 5)
          for i, t in enumerate(ins)]
    y, sT = wkv6(*xs)
    loss = (y * torch.from_numpy(dy)).sum() + (sT * torch.from_numpy(dsT)).sum()
    loss.backward()
    assert calls == ["forward", "backward"]
    want = _autograd(wkv6_plain, ins, dy, dsT)
    _check([x.grad for x in xs[:5]], want[:5])
    if s0_grad:
        _check([xs[5].grad], want[5:], names=("s0",))
    else:
        assert xs[5].grad is None


# ---------------------------------------------------------------------------
# On the card: the backward kernels against the plain backward
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, B, T, H, N, **kw):
    return [torch.from_numpy(t).to(dev) for t in _inputs(B, T, H, N, **kw)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,N,decay_shift,s0_scale", [
    (2, 300, 4, 64, -1.0, 0.3),     # the model's N, T across 10 chunks
    (2, 130, 4, 64, -1.0, 0.0),     # an unaligned T, zero s0
    (2, 32, 4, 64, -1.0, 0.3),      # one chunk
    (3, 77, 2, 32, -1.0, 0.3),      # a small N
    (2, 200, 4, 64, 2.0, 0.3),      # strong decay
])
def test_kernel_matches_plain_backward_on_gpu(cuda, B, T, H, N,
                                              decay_shift, s0_scale):
    ins = _on(cuda, B, T, H, N, decay_shift=decay_shift, s0_scale=s0_scale)
    before = wkv6_bwd.launches
    got = wkv6_bwd(*ins)
    again = wkv6_bwd(*ins)
    want = wkv6_bwd_plain(*ins)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == before + 2
    _check([t.cpu() for t in got], [t.cpu() for t in want])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_unaligned_rows_and_no_state_cotangent_on_gpu(cuda):
    *ins, dy, _ = _on(cuda, 2, 100, 4, 64, seed=6)
    flat = torch.empty(ins[0].numel() + 1, device=cuda)[1:]
    ins[0] = flat.view(ins[0].shape).copy_(ins[0])
    got = wkv6_bwd(*ins, dy, None)
    want = wkv6_bwd_plain(*ins, dy, None)
    torch.cuda.synchronize()
    _check([t.cpu() for t in got], [t.cpu() for t in want])


@pytest.mark.gpu
def test_autograd_runs_the_kernels_on_gpu(cuda):
    *ins, dy, dsT = _on(cuda, 2, 150, 4, 64, seed=7)
    xs = [t.clone().requires_grad_(True) for t in ins]
    f0, b0 = wkv6.launches, wkv6_bwd.launches
    y, sT = wkv6(*xs)
    ((y * dy).sum() + (sT * dsT).sum()).backward()
    torch.cuda.synchronize()
    assert (wkv6.launches - f0, wkv6_bwd.launches - b0) == (1, 1)
    want = wkv6_bwd_plain(*ins, dy, dsT)
    _check([x.grad.cpu() for x in xs], [t.cpu() for t in want])
