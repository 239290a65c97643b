"""The gradient of the port's Mamba-2 SSD scan (K5) against the JAX
package's.

CPU cases: seeded numpy inputs and random cotangents for both outputs (y
and h_T) through ``jax.vjp`` of ``repro.models.mamba2.ssd_chunked`` (the
jnp path the JAX package trains through) and through the port: autograd
of ``ssd_plain`` and ``ssd_bwd_plain`` (the backward kernels' formula in
their factoring: the states and adjoints at the chunk boundaries by two
scans, then every chunk's terms at once).  Tolerance: 1e-4 relative to each leaf's
largest entry (the sides cut the sequence into other chunks and sum in
other orders).  A strong-decay case (A = -exp(normal + 3), as zamba2's
heads decay by up to exp(-16 dt) a step) is held against autograd of the
step-by-step ``ssd_ref`` in float64: that is where the reverse-sum form
of dA's gradient lost precision, which the port's term-by-term form does
not.  The wrapper's autograd route (``SsdFn``, taken on CUDA tensors
that require a gradient) is shown on CPU tensors posing as CUDA ones, its
launches swapped for the plain versions.

GPU cases (marker ``gpu``, skipped without a CUDA device): the backward
kernels (the chunk-boundary scans, then the chunk-parallel kernel over
groups of heads) against ``ssd_bwd_plain`` on the card at 1e-4 of each
leaf's largest entry, bit for bit across two calls: zamba2's training
shape, an unaligned T with a nonzero h0 and dhT, small and odd P and N,
strong decay, head counts that are not a multiple of the group, a single
chunk, Bm rows 66 floats apart; and autograd on CUDA tensors through
``SsdFn``.  They need no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba2_ssd import ops
from repro_torch.kernels.mamba2_ssd import (ssd, ssd_bwd, ssd_bwd_plain,
                                            ssd_plain)

REL = 1e-4          # of each leaf's largest entry
NAMES = ("x", "dt", "A", "Bm", "Cm", "h0")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers small eager
    ops slow down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, T, H, P, N, seed=0, a_shift=0.0, h0_scale=0.3):
    """x, dt = softplus(normal), A = -exp(normal + a_shift), Bm, Cm, h0 and
    the cotangents dy, dhT, float32 numpy (tests/test_kernels.py's
    distributions)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, T, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H))))
    A = -np.exp(rng.standard_normal(H) + a_shift)
    Bm, Cm = (rng.standard_normal((B, T, N)) for _ in range(2))
    h0 = h0_scale * rng.standard_normal((B, H, P, N))
    dy = rng.standard_normal((B, T, H, P))
    dhT = rng.standard_normal((B, H, P, N))
    return [t.astype(f) for t in (x, dt, A, Bm, Cm, h0, dy, dhT)]


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
    """``jax.vjp`` of the JAX model's ``ssd_chunked``: (inputs, dy, dhT,
    chunk) -> (y, h_T, the six gradients) as numpy."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models.mamba2 import ssd_chunked

    def run(ins, dy, dhT, chunk):
        out, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk=chunk),
                           *(jnp.asarray(t) for t in ins))
        grads = vjp((jnp.asarray(dy), jnp.asarray(dhT)))
        return [np.asarray(t) for t in (*out, *grads)]
    return run


def _autograd(fn, ins, dy, dhT, dtype=torch.float32):
    """The six gradients of ``fn``'s (y, h_T) by autograd."""
    xs = [torch.from_numpy(t).to(dtype).requires_grad_(True) for t in ins]
    y, hT = fn(*xs)
    loss = ((y * torch.from_numpy(dy).to(dtype)).sum()
            + (hT * torch.from_numpy(dhT).to(dtype)).sum())
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


# (B, T, H, P, N, JAX chunk, h0 scale, seed): a chunk boundary of the
# port's 32-step chunks inside the sequence, T not a multiple of it, P !=
# N, a zero h0
CASES = [(2, 64, 3, 16, 8, 16, 0.3, 0), (1, 40, 2, 8, 16, 8, 0.3, 1),
         (2, 48, 4, 16, 16, 16, 0.0, 2)]


@pytest.mark.parametrize("B,T,H,P,N,chunk,h0_scale,seed", CASES)
def test_plain_backward_matches_jax_vjp(jax_vjp, B, T, H, P, N, chunk,
                                        h0_scale, seed):
    *ins, dy, dhT = _inputs(B, T, H, P, N, seed=seed, h0_scale=h0_scale)
    want = jax_vjp(ins, dy, dhT, chunk)
    got = ssd_bwd(*(torch.from_numpy(t) for t in (*ins, dy, dhT)))
    _check(got, want[2:])


@pytest.mark.parametrize("B,T,H,P,N,chunk,h0_scale,seed", CASES)
def test_autograd_of_plain_matches_jax_vjp(jax_vjp, B, T, H, P, N, chunk,
                                           h0_scale, seed):
    *ins, dy, dhT = _inputs(B, T, H, P, N, seed=seed, h0_scale=h0_scale)
    want = jax_vjp(ins, dy, dhT, chunk)
    _check(_autograd(ssd_plain, ins, dy, dhT), want[2:])


def test_without_a_state_cotangent(jax_vjp):
    """dhT = None (the model drops h_T) is a zero cotangent."""
    *ins, dy, dhT = _inputs(2, 32, 2, 8, 8, seed=3)
    want = jax_vjp(ins, dy, np.zeros_like(dhT), 16)
    got = ssd_bwd_plain(*(torch.from_numpy(t) for t in (*ins, dy)), None)
    _check(got, want[2:])


def _ssd_steps(x, dt, A, Bm, Cm, h):
    """The literal recurrence in the inputs' dtype (``ssd_ref`` casts to
    float32): h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t."""
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None]
             * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def test_strong_decay_against_the_step_oracle():
    """A = -exp(normal + 3) over 512 steps: every gradient, dA's included,
    within 1e-4 of each leaf's largest entry of float64 autograd of the
    step-by-step recurrence."""
    *ins, dy, dhT = _inputs(1, 512, 2, 16, 8, seed=4, a_shift=3.0)
    want = _autograd(_ssd_steps, ins, dy, dhT, torch.float64)
    got = ssd_bwd_plain(*(torch.from_numpy(t) for t in (*ins, dy, dhT)))
    _check(got, want)


@pytest.mark.parametrize("h0_grad", [True, False])
def test_cuda_tensors_take_the_autograd_function(monkeypatch, h0_grad):
    """On CUDA tensors that require a gradient, ``ssd`` goes through
    ``SsdFn`` (no refusal): shown on CPU tensors posing as CUDA ones, the
    forward launch and the backward swapped for the plain versions.  Its
    gradients are autograd's of the plain version, h0's None where h0
    needs none."""
    calls = []

    def fwd(*a):
        calls.append("forward")
        return ssd_plain(*a)

    def bwd(*a):
        calls.append("backward")
        return ssd_bwd_plain(*a)
    monkeypatch.setattr(ops, "is_cuda", lambda *t: True)
    monkeypatch.setattr(ops, "_forward", fwd)
    monkeypatch.setattr(ops, "ssd_bwd", bwd)
    *ins, dy, dhT = _inputs(2, 40, 3, 8, 8, seed=5)
    xs = [torch.from_numpy(t).requires_grad_(h0_grad or i < 5)
          for i, t in enumerate(ins)]
    y, hT = ssd(*xs)
    loss = (y * torch.from_numpy(dy)).sum() + (hT * torch.from_numpy(dhT)).sum()
    loss.backward()
    assert calls == ["forward", "backward"]
    want = _autograd(ssd_plain, ins, dy, dhT)
    _check([x.grad for x in xs[:5]], want[:5])
    if h0_grad:
        _check([xs[5].grad], want[5:], names=("h0",))
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


def _on(dev, B, T, H, P, N, **kw):
    return [torch.from_numpy(t).to(dev)
            for t in _inputs(B, T, H, P, N, **kw)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,P,N,a_shift,h0_scale", [
    (2, 300, 8, 64, 64, 0.0, 0.3),   # the model's P, N across 10 chunks
    (2, 130, 8, 64, 64, 0.0, 0.0),   # an unaligned T, zero h0
    (3, 77, 4, 32, 16, 0.0, 0.3),    # small P, N
    (2, 200, 8, 64, 64, 3.0, 0.3),   # strong decay
    (4, 2048, 80, 64, 64, 0.0, 0.3),  # zamba2-2.7b's training shape
    (2, 130, 80, 64, 64, 0.0, 0.3),  # an unaligned T, nonzero h0 and dhT
    (2, 100, 8, 32, 16, 0.0, 0.3),   # P=32, N=16
    (2, 512, 80, 64, 64, 3.0, 0.3),  # strong decay over 16 chunks
    (2, 150, 6, 64, 64, 0.0, 0.3),   # H=6: a head group of 6 of 8
    (3, 20, 11, 64, 64, 0.0, 0.3),   # one chunk; groups of 8 and 3
    (2, 70, 5, 20, 12, 0.0, 0.3),    # P, N not multiples of 16 (4-byte copies)
    (1, 45, 3, 7, 5, 0.0, 0.3),      # odd P, N
])
def test_kernel_matches_plain_backward_on_gpu(cuda, B, T, H, P, N, a_shift,
                                              h0_scale):
    ins = _on(cuda, B, T, H, P, N, a_shift=a_shift, h0_scale=h0_scale)
    before = ssd_bwd.launches
    got = ssd_bwd(*ins)
    again = ssd_bwd(*ins)
    want = ssd_bwd_plain(*ins)
    torch.cuda.synchronize()
    assert ssd_bwd.launches == before + 2
    _check([t.cpu() for t in got], [t.cpu() for t in want])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_strided_rows_and_no_state_cotangent_on_gpu(cuda):
    *ins, dy, _ = _on(cuda, 2, 100, 8, 64, 64, seed=6)
    ins[3] = torch.nn.functional.pad(ins[3], (0, 2))[..., :64]
    got = ssd_bwd(*ins, dy, None)
    want = ssd_bwd_plain(*ins, dy, None)
    torch.cuda.synchronize()
    _check([t.cpu() for t in got], [t.cpu() for t in want])


@pytest.mark.gpu
def test_autograd_runs_the_kernels_on_gpu(cuda):
    *ins, dy, dhT = _on(cuda, 2, 150, 8, 64, 64, seed=7)
    xs = [t.clone().requires_grad_(True) for t in ins]
    f0, b0 = ssd.launches, ssd_bwd.launches
    y, hT = ssd(*xs)
    ((y * dy).sum() + (hT * dhT).sum()).backward()
    torch.cuda.synchronize()
    assert (ssd.launches - f0, ssd_bwd.launches - b0) == (1, 1)
    want = ssd_bwd_plain(*ins, dy, dhT)
    _check([x.grad.cpu() for x in xs], [t.cpu() for t in want])


def test_fault_anchors_occur_once():
    """scripts/recurrent_bwd_fault.py plants each fault by replacing text
    that occurs exactly once in K4's or K5's backward source."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "recurrent_bwd_fault", root / "scripts" / "recurrent_bwd_fault.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert len(mod.FAULTS) >= 3
    for name, (path, old, new) in mod.FAULTS.items():
        assert (root / "src" / path).read_text().count(old) == 1, name
        assert old != new
