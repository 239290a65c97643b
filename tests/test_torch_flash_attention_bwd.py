"""The gradient of the port's flash attention against the JAX package's.

CPU cases: the same numpy inputs and output gradient through ``jax.vjp``
of the JAX attention (``repro.models.attention.gqa_attention`` under
``make_mask``, the path the JAX package trains through) and through the
port: autograd of the wrapper on CPU tensors (its plain version) and
``flash_attention_bwd_plain``, the backward kernel's formula written out.
fp32, tolerance 2e-5 (the sides sum in different orders).  A row that
sees no key gets zero gradients (the JAX attention averages it uniformly
instead, so those rows are checked on the port alone).

GPU cases (marker ``gpu``, skipped without a CUDA device): the backward
kernel against ``flash_attention_bwd_plain`` on the card, fp32 at 2e-5 and
bf16 at 3e-2 (tests/test_kernels.py's tolerances); two runs give the same
bits; the forward's lse equals the plain one; O is bit for bit the same
with or without lse; autograd on CUDA tensors runs the kernels.  They
need no JAX.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)

TOL32 = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers (each with
    every core's worth of threads) small eager ops slow down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (name, B, S, Skv, H, K, hd, causal, window, ragged)
CASES = [
    ("causal G=4", 2, 64, 64, 8, 2, 32, True, None, False),
    ("window 16", 2, 80, 80, 4, 2, 32, True, 16, False),
    ("ragged lengths", 3, 50, 50, 4, 1, 16, True, None, True),
    ("Skv != S non-causal", 2, 40, 70, 4, 2, 32, False, None, True),
    ("hd 80", 1, 48, 48, 4, 2, 80, True, None, False),
]


@pytest.fixture(scope="module")
def jax_attn():
    """``jax.vjp`` of the JAX attention: (q, k, v, do, lengths) -> grads."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models.attention import gqa_attention, make_mask

    @functools.partial(jax.jit, static_argnames=("causal", "window"))
    def run(q, k, v, do, kvl, *, causal, window):
        mask = make_mask(q.shape[1], k.shape[1], causal=causal,
                         window=window, kv_lengths=kvl)
        out, vjp = jax.vjp(lambda a, b, c: gqa_attention(a, b, c, mask),
                           q, k, v)
        return out, vjp(do)

    def grads(q, k, v, do, *, causal, window, lengths):
        kvl = None if lengths is None else jnp.asarray(lengths)
        out, g = run(*(jnp.asarray(x) for x in (q, k, v, do)), kvl,
                     causal=causal, window=window)
        return np.asarray(out), [np.asarray(x) for x in g]
    return grads


def _inputs(B, S, Skv, H, K, hd, ragged, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    lengths = None
    if ragged:
        lengths = rng.integers(1, Skv + 1, (B,)).astype(np.int32)
        lengths[0] = Skv
    return q, k, v, do, lengths


def _port_grads(q, k, v, do, *, causal, window, lengths):
    """Autograd of the wrapper on CPU tensors, and the plain backward."""
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tl = None if lengths is None else torch.tensor(lengths)
    out = flash_attention(tq, tk, tv, causal=causal, window=window,
                          lengths=tl)
    out.backward(torch.tensor(do))
    auto = [t.grad.numpy() for t in (tq, tk, tv)]
    o, lse = flash_attention_plain(*(torch.tensor(x) for x in (q, k, v)),
                                   causal=causal, window=window, lengths=tl,
                                   return_lse=True)
    plain = flash_attention_bwd_plain(
        *(torch.tensor(x) for x in (q, k, v)), o, lse, torch.tensor(do),
        causal=causal, window=window, lengths=tl)
    return out.detach().numpy(), auto, [g.numpy() for g in plain]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grads_match_jax_vjp(jax_attn, case):
    _, B, S, Skv, H, K, hd, causal, window, ragged = case
    q, k, v, do, lengths = _inputs(B, S, Skv, H, K, hd, ragged)
    kw = dict(causal=causal, window=window, lengths=lengths)
    want_out, want = jax_attn(q, k, v, do, **kw)
    out, auto, plain = _port_grads(q, k, v, do, **kw)
    assert_allclose(out, want_out, **TOL32)
    for name, a, p, w in zip(("dq", "dk", "dv"), auto, plain, want):
        assert_allclose(a, w, err_msg=f"autograd {name}", **TOL32)
        assert_allclose(p, w, err_msg=f"plain backward {name}", **TOL32)


def test_empty_rows_get_zero_gradients():
    q, k, v, do, _ = _inputs(3, 20, 24, 4, 2, 16, False, seed=3)
    lengths = np.array([24, 0, 7], np.int32)
    # window 2 also leaves queries 9.. of row 2 without a key (keys < 7)
    _, auto, plain = _port_grads(q, k, v, do, causal=True, window=2,
                                 lengths=lengths)
    for grads in (auto, plain):
        dq, dk, dv = grads
        assert np.isfinite(dq).all() and np.isfinite(dk).all()
        assert not dq[1].any() and not dk[1].any() and not dv[1].any()
        assert not dq[2, 9:].any() and not dk[2, 7:].any()
        assert dq[0].any() and dk[2, :7].any()


def test_plain_lse_is_logsumexp_and_inf_on_empty_rows():
    q, k, v, _, _ = _inputs(2, 12, 12, 2, 1, 8, False, seed=5)
    lengths = torch.tensor([12, 0])
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    _, lse = flash_attention_plain(tq, tk, tv, causal=True, lengths=lengths,
                                   return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / np.sqrt(8)
    keep = torch.ones(12, 12).tril().bool()
    want = torch.logsumexp(s[0].masked_fill(~keep, -torch.inf), -1)
    assert_allclose(lse[0].numpy(), want.numpy(), **TOL32)
    assert torch.isneginf(lse[1]).all()


def test_cpu_call_counts_no_launch():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    before = (flash_attention.launches, flash_attention_bwd.launches)
    q, k, v, do, _ = _inputs(1, 8, 8, 2, 1, 8, False)
    _port_grads(q, k, v, do, causal=True, window=None, lengths=None)
    o, lse = flash_attention_plain(*(torch.tensor(x) for x in (q, k, v)),
                                   return_lse=True)
    flash_attention_bwd(*(torch.tensor(x) for x in (q, k, v)), o, lse,
                        torch.tensor(do))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


def test_fault_anchors_occur_once():
    """scripts/k1_bwd_fault.py plants each fault by replacing text that
    occurs exactly once in the backward source (a helper that both the
    tensor-core and the CUDA-core kernels call)."""
    import importlib.util
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "k1_bwd_fault", root / "scripts" / "k1_bwd_fault.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = ops.BWD_SOURCE.read_text()
    assert set(mod.FAULTS) == {"diagonal", "delta", "last_tile"}
    for name, (old, new) in mod.FAULTS.items():
        assert text.count(old) == 1, name
        assert old != new


def test_library_name_hashes_the_shared_header(tmp_path):
    """An edit to a header alone (sm90.cuh) must name a new library, or a
    stale build would load."""
    from repro_torch.kernels import common
    src, hdr = tmp_path / "k.cu", tmp_path / "h.cuh"
    src.write_text('#include "h.cuh"\n')
    hdr.write_text("// one\n")
    first = common.library_path("k", [src], [hdr])
    assert first == common.library_path("k", [src], [hdr])
    assert first != common.library_path("k", [src])
    hdr.write_text("// two\n")
    assert common.library_path("k", [src], [hdr]) != first
    assert first.parent == common.BUILD_DIR and first.name.startswith("libk-")
    # both of K1's libraries hash the header they include
    for source in (ops.SOURCE, ops.BWD_SOURCE):
        assert '#include "sm90.cuh"' in source.read_text()
    assert ops.HEADER.is_file()


# ---------------------------------------------------------------------------
# GPU: the kernels against the plain versions on the card
# ---------------------------------------------------------------------------

GPU_CASES = [
    # (name, B, S, Skv, H, K, hd, dtype, causal, window, ragged, offset)
    ("danube hd=80 G=4 causal", 2, 300, 300, 8, 2, 80, "bfloat16", True,
     None, False, 0),
    ("hd=64 window 40", 2, 200, 200, 4, 2, 64, "bfloat16", True, 40, False,
     0),
    ("hd=128 ragged with an empty row", 3, 130, 130, 4, 1, 128, "bfloat16",
     True, None, True, 0),
    ("hd=96 cross Skv=333", 2, 70, 333, 4, 4, 96, "bfloat16", False, None,
     False, 0),
    ("bf16 unaligned rows (CUDA cores)", 2, 90, 90, 4, 2, 64, "bfloat16",
     True, None, False, 1),
    ("hd=32 bf16 (CUDA cores)", 2, 100, 100, 4, 2, 32, "bfloat16", True,
     None, True, 0),
    ("fp32 causal G=4", 2, 150, 150, 8, 2, 64, "float32", True, None, False,
     0),
    ("fp32 encoder non-causal hd=64", 1, 300, 300, 8, 8, 64, "float32",
     False, None, False, 0),
    ("fp32 hd=256 window 20 ragged", 2, 90, 90, 2, 1, 256, "float32", True,
     20, True, 0),
    ("fp32 cross Skv < S ragged", 2, 120, 50, 4, 2, 32, "float32", False,
     None, True, 0),
    # the wgmma kernels' edges: S and Skv one off a multiple of 64 and 128,
    # lengths at a tile's edges (a tuple: one per batch row), a window of
    # one tile, G = 12, and danube's hd 80 over a whole list of items
    ("hd=128 S=127 causal", 2, 127, 127, 4, 2, 128, "bfloat16", True, None,
     False, 0),
    ("hd=64 S=129 Skv=191 non-causal", 2, 129, 191, 4, 2, 64, "bfloat16",
     False, None, False, 0),
    ("hd=80 S=191 Skv=65 causal", 2, 191, 65, 8, 2, 80, "bfloat16", True,
     None, False, 0),
    ("hd=96 S=63 Skv=129 causal", 2, 63, 129, 4, 1, 96, "bfloat16", True,
     None, False, 0),
    ("hd=128 lengths 63, 64, 65, 128", 4, 130, 130, 4, 2, 128, "bfloat16",
     True, None, (63, 64, 65, 128), 0),
    ("hd=80 non-causal lengths 63, 64, 65, 128", 4, 100, 129, 4, 2, 80,
     "bfloat16", False, None, (63, 64, 65, 128), 0),
    ("hd=80 window 64", 2, 300, 300, 8, 2, 80, "bfloat16", True, 64, False,
     0),
    ("G=12 hd=128", 1, 200, 200, 24, 2, 128, "bfloat16", True, None, False,
     0),
    ("danube hd=80 S=2048", 1, 2048, 2048, 32, 8, 80, "bfloat16", True, None,
     False, 0),
]
TOL = {"bfloat16": dict(rtol=3e-2, atol=3e-2), "float32": TOL32}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gpu_case(case, seed=0):
    _, B, S, Skv, H, K, hd, dtype, causal, window, ragged, offset = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def t(*shape):
        full = torch.randn(*shape[:-1], shape[-1] + offset, generator=g,
                           device="cuda").to(dt)
        return full[..., offset:]
    q, k, v, do = t(B, S, H, hd), t(B, Skv, K, hd), t(B, Skv, K, hd), \
        t(B, S, H, hd)
    lengths = None
    if isinstance(ragged, tuple):
        lengths = torch.tensor(ragged, dtype=torch.int32, device="cuda")
    elif ragged:
        lengths = torch.randint(1, Skv + 1, (B,), generator=g,
                                device="cuda", dtype=torch.int32)
        lengths[0] = Skv
        if B > 2:
            lengths[1] = 0
    return q, k, v, do, dict(causal=causal, window=window, lengths=lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=[c[0] for c in GPU_CASES])
def test_kernel_matches_plain_backward(cuda, case):
    q, k, v, do, kw = _gpu_case(case)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    tol = TOL[case[7]]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.isfinite(a).all(), name
        a, w = a.float(), w.float()
        atol = tol["atol"] * min(1.0, float(w.abs().max()))
        assert torch.allclose(a, w, rtol=tol["rtol"], atol=atol), \
            f"{name}: max err {float((a - w).abs().max())}"


DET_CASES = GPU_CASES[:2] + GPU_CASES[6:7] + GPU_CASES[-1:]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DET_CASES, ids=[c[0] for c in DET_CASES])
def test_kernel_is_deterministic(cuda, case):
    q, k, v, do, kw = _gpu_case(case)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    a = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    b = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=[c[0] for c in GPU_CASES])
def test_forward_lse_and_bitwise_output(cuda, case):
    q, k, v, _, kw = _gpu_case(case)
    lengths = ops._check(q, k, v, kw["lengths"])
    o1, lse = ops._forward(q, k, v, kw["causal"], kw["window"], lengths,
                           with_lse=True)
    o0, none = ops._forward(q, k, v, kw["causal"], kw["window"], lengths,
                            with_lse=False)
    _, want = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert none is None and torch.equal(o0, o1)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want))
    fin = torch.isfinite(want)
    tol = 1e-5 if case[7] == "float32" else 1e-4
    assert torch.allclose(lse[fin], want[fin], rtol=tol, atol=tol)


@pytest.mark.gpu
def test_autograd_runs_the_kernels(cuda):
    q, k, v, do, kw = _gpu_case(GPU_CASES[0])
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    n_fwd, n_bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(q, k, v, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_attention.launches == n_fwd + 1
    assert flash_attention_bwd.launches == n_bwd + 1
    o, lse = ops._forward(q.detach(), k.detach(), v.detach(), kw["causal"],
                          kw["window"], None, with_lse=True)
    want = flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                               do, **kw)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)
    with torch.no_grad():      # serving: the plain forward launch, no lse
        flash_attention(q, k, v, **kw)
    assert flash_attention_bwd.launches == n_bwd + 2


# ---------------------------------------------------------------------------
# K2 and K3 have no backward kernel (nothing trains through a decode step):
# on CUDA they refuse where autograd would need their gradient.  Shown here
# without a card by making the wrappers take CPU tensors for CUDA ones: the
# refusal comes before any launch.  K4 and K5 have backward kernels; their
# autograd route is shown in test_torch_rwkv6_wkv_bwd.py and
# test_torch_mamba2_ssd_bwd.py.
# ---------------------------------------------------------------------------


def _k2_k5_calls():
    from repro_torch.kernels.decode_attention import ops as da
    r = lambda *s: torch.randn(*s)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    return {
        "decode_attention": (da, lambda: da.decode_attention(
            r(2, 4, 16), r(2, 8, 2, 16), r(2, 8, 2, 16), lengths)),
        "paged_decode_attention": (da, lambda: da.paged_decode_attention(
            r(2, 4, 16), r(4, 4, 2, 16), r(4, 4, 2, 16),
            torch.tensor([[1, 2], [3, 0]], dtype=torch.int32), lengths)),
    }


@pytest.mark.parametrize("name", ["decode_attention",
                                  "paged_decode_attention"])
def test_k2_k5_refuse_a_gradient_on_cuda(monkeypatch, name):
    module, call = _k2_k5_calls()[name]
    monkeypatch.setattr(module, "is_cuda", lambda *t: True)
    monkeypatch.setattr(module, "build", lambda: pytest.fail("launched"))
    real = torch.randn

    def grad_randn(*shape, **kw):
        return real(*shape, **kw).requires_grad_(True)
    monkeypatch.setattr(torch, "randn", grad_randn)
    with pytest.raises(RuntimeError, match=f"{name} has no backward kernel"):
        call()
    monkeypatch.setattr(torch, "randn", real)
    def no_card():
        raise LookupError("no card")
    monkeypatch.setattr(module, "build", no_card)
    with torch.no_grad():         # no gradient needed: the guard lets it by
        with pytest.raises(Exception) as e:   # ... to what needs the card
            call()
    assert "no backward kernel" not in str(e.value)
