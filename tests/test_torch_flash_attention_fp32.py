"""K1's float32 route on the tensor cores (TF32 x 3 on mma.sync).

CPU cases:
  * the route predicate ``ops.tensor_core_path``: whisper's encoder shape
    (S = Skv = 1500, 8/8 heads of 64, fp32) takes the tensor cores; hd 32
    or 256, rows off a 16-byte boundary or strided by a non-multiple of 4
    floats do not; bf16 routes as the C entry routed it before;
  * the cost functions' work counts and the two bounds of the fp32 rows
    (the CUDA cores' fp32 peak, and the TF32 x 3 bound: the products at a
    third of the TF32 peak);
  * a CPU emulation of the three-term split on float32 bit patterns: hi
    rounded to nearest (ties away, cvt.rna.tf32) at TF32's 10-bit
    mantissa, lo = x - hi read truncated as the tensor cores read it, each
    product hi*lo + lo*hi + hi*hi with float32 sums.  At one whisper
    encoder head (S = Skv = 1500, hd 64, keys shifted by 2 as chip_smoke.py
    shifts them) the forward and the backward stay within the float32
    tolerance (rtol = atol = 2e-5, atol scaled by min(1, max|ref|)) and the
    backward within chip_smoke.py's relative L2 bound (1e-5) of a float64
    reference, where a single TF32 product (hi * hi) misses the tolerance
    many times over (the factor is asserted above 10).
  * the TF32 x 3 helpers live in one header that K1, K4 and K5 include;
    a library's ptxas report is kept beside it for later processes.

GPU cases (marker ``gpu``, skipped without a CUDA device; no JAX): the
forward (B=8) and backward (B=2) at whisper's fp32 encoder shape on the
card, within the float32 tolerance of the plain version and of a float64
reference, the tensor-core route asserted, two runs bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.roofline import kernel_bound, tc_bound
from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain, ops)

RTOL = ATOL = 2e-5          # chip_smoke.TOL["float32"]
BWD_REL_L2 = 1e-5           # chip_smoke.BWD_REL_L2["float32"]
WHISPER = dict(S=1500, H=8, K=8, hd=64)
KEY_SHIFT = 2.0             # chip_smoke.KEY_SHIFT


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    default of a thread per core slows small eager ops many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------


def _rows(shape, dtype, *, width=None, offset=0):
    """A (B, S, H, hd) view whose rows are ``width`` elements apart,
    starting ``offset`` elements into each."""
    B, S, H, hd = shape
    full = torch.zeros(B, S, H, (width or hd) + offset, dtype=dtype)
    return full[..., offset:offset + hd]


ROUTES = [
    # (name, q shape, dtype, width, offset, tensor cores)
    ("whisper encoder fp32", (2, 1500, 8, 64), torch.float32, None, 0, True),
    ("fp32 hd 80", (2, 33, 4, 80), torch.float32, None, 0, True),
    ("fp32 hd 96", (2, 33, 4, 96), torch.float32, None, 0, True),
    ("fp32 hd 128 strided by 2 hd", (2, 33, 4, 128), torch.float32, 256, 0,
     True),
    ("fp32 hd 32", (2, 33, 4, 32), torch.float32, None, 0, False),
    ("fp32 hd 256", (2, 33, 4, 256), torch.float32, None, 0, False),
    ("fp32 rows one float off", (2, 33, 4, 64), torch.float32, None, 1,
     False),
    ("fp32 rows 66 floats apart", (2, 33, 4, 64), torch.float32, 66, 0,
     False),
    ("bf16 hd 64", (2, 33, 4, 64), torch.bfloat16, None, 0, True),
    ("bf16 hd 80", (2, 33, 4, 80), torch.bfloat16, None, 0, True),
    ("bf16 hd 32", (2, 33, 4, 32), torch.bfloat16, None, 0, False),
    ("bf16 rows one element off", (2, 33, 4, 128), torch.bfloat16, None, 1,
     False),
    ("bf16 rows 132 elements apart", (2, 33, 4, 128), torch.bfloat16, 132,
     0, False),
]


@pytest.mark.parametrize("name,shape,dtype,width,offset,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_predicate(name, shape, dtype, width, offset, want):
    q = _rows(shape, dtype, width=width, offset=offset)
    kv = _rows(shape, dtype)
    assert ops.tensor_core_path(q, kv, kv) is want
    assert ops.tensor_core_path(kv, q, kv) is want      # any operand counts


def test_route_sees_every_operand():
    """The backward also holds dO to the tensor cores' alignment."""
    q = _rows((1, 40, 8, 64), torch.float32)
    off = _rows((1, 40, 8, 64), torch.float32, offset=1)
    assert ops.tensor_core_path(q, q, q, q)
    assert not ops.tensor_core_path(q, q, q, off)


# ---------------------------------------------------------------------------
# Work counts and bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which,B,flops,fp32_ms,tc_ms", [
    # whisper's encoder: B=8 forward, B=2 backward (phase 3's timings)
    ("forward", 8, 4 * 64 * 8 * 8 * 1500 ** 2, 0.5502, 0.2234),
    ("backward", 2, 2.5 * 4 * 64 * 8 * 2 * 1500 ** 2, 0.3439, 0.1396),
])
def test_fp32_bounds_at_whisper(which, B, flops, fp32_ms, tc_ms):
    fn = (ops.flash_attention_cost if which == "forward"
          else ops.flash_attention_bwd_cost)
    S, H, K, hd = (WHISPER[x] for x in ("S", "H", "K", "hd"))
    cost = fn(B, S, S, H, K, hd, 4, causal=False)
    assert cost.flops == pytest.approx(flops, rel=1e-12)
    per_side = 2 if which == "forward" else 4
    assert cost.nbytes == 4 * per_side * (B * S * H * hd + B * S * K * hd)
    bound, by = kernel_bound(cost.nbytes, cost.flops, "float32")
    tc, tc_by = tc_bound(cost.nbytes, cost.flops, 0.0)
    assert (by, tc_by) == ("operations", "operations")
    assert bound == pytest.approx(fp32_ms, abs=1e-4)
    assert tc == pytest.approx(tc_ms, abs=1e-4)
    assert tc == pytest.approx(bound * 3 * 67 / 495, rel=1e-9)


# ---------------------------------------------------------------------------
# The three-term split, emulated on the CPU
# ---------------------------------------------------------------------------


def tf32_hi(x):
    """The kernels' hi (tf32x3::split_bits, cvt.rna.tf32.f32's bits): the
    float32 bit pattern rounded to nearest, ties away from zero, at TF32's
    10 mantissa bits (the low 13 bits zeroed)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    """How the tensor cores read a float32 operand as TF32: truncated."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def prod3(a, b):
    """a @ b as the kernels take it: both split into hi + lo, the cross
    terms first, then hi * hi, float32 sums."""
    ah, bh = tf32_hi(a), tf32_hi(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def prod1(a, b):
    """a @ b as one TF32 product."""
    return tf32_hi(a) @ tf32_hi(b)


def test_tf32_hi_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                        1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0],
                       dtype=torch.float32)
    got = tf32_hi(one)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0],
                        dtype=torch.float32)
    assert torch.equal(got, want)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        10000).astype(np.float32))
    h = tf32_hi(x)
    assert not (h.view(torch.int32) & 0x1FFF).any()
    assert ((x - h).abs() <= 2.0 ** -11 * x.abs()).all()


@pytest.fixture(scope="module")
def whisper_head():
    """One head of whisper's encoder: q, k (shifted), v and dO from a
    numpy seed, and the float64 reference: o, lse and the gradients."""
    r = np.random.default_rng(0)
    S, hd = WHISPER["S"], WHISPER["hd"]
    q = r.standard_normal((S, hd)).astype(np.float32)
    k = (r.standard_normal((S, hd)) + KEY_SHIFT).astype(np.float32)
    v = r.standard_normal((S, hd)).astype(np.float32)
    do = r.standard_normal((S, hd)).astype(np.float32)
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    scale = hd ** -0.5
    s = q64 @ k64.T * scale
    lse = torch.logsumexp(s, 1)
    p = torch.exp(s - lse[:, None])
    o = p @ v64
    ds = p * (do64 @ v64.T - (do64 * o).sum(1)[:, None])
    grads = (ds @ k64 * scale, ds.T @ q64 * scale, p.T @ do64)
    return dict(q=q, k=k, v=v, do=do, scale=scale, o=o, lse=lse,
                grads=grads)


def _tol_ratio(got, want):
    """The largest |got - want| over the float32 tolerance (atol scaled
    by min(1, max|want|), as chip_smoke.scaled_tol): <= 1 passes."""
    atol = ATOL * min(1.0, float(want.abs().max()))
    return float(((got.double() - want).abs()
                  / (atol + RTOL * want.abs())).max())


def _forward(h, prod):
    s = prod(h["q"], h["k"].T)
    m = s.max(1).values
    p = torch.exp((s - m[:, None]) * h["scale"])
    return prod(p, h["v"]) / p.sum(1)[:, None]


def _backward(h, prod):
    o, lse = h["o"].float(), h["lse"].float()
    q, k, v, do, scale = h["q"], h["k"], h["v"], h["do"], h["scale"]
    p = torch.exp(prod(q, k.T) * scale - lse[:, None])
    ds = p * (prod(do, v.T) - (do * o).sum(1)[:, None])
    return (prod(ds, k) * scale, prod(ds.T.contiguous(), q) * scale,
            prod(p.T.contiguous(), do))


def test_tf32x3_forward_within_fp32_tol(whisper_head):
    three = _tol_ratio(_forward(whisper_head, prod3), whisper_head["o"])
    one = _tol_ratio(_forward(whisper_head, prod1), whisper_head["o"])
    print(f"forward at one whisper head: TF32 x 3 at {three:.3f} of the "
          f"float32 tolerance, one TF32 product at {one:.1f}")
    assert three <= 1.0
    assert one > 10.0


def test_tf32x3_backward_within_fp32_tol(whisper_head):
    for prod, inside in ((prod3, True), (prod1, False)):
        for name, got, want in zip(("dq", "dk", "dv"),
                                   _backward(whisper_head, prod),
                                   whisper_head["grads"]):
            ratio = _tol_ratio(got, want)
            rel = float((got.double() - want).norm() / want.norm())
            print(f"backward {name} at one whisper head, "
                  f"{'TF32 x 3' if inside else 'one TF32 product'}: "
                  f"{ratio:.3f} of the tolerance, relative L2 {rel:.2e}")
            if inside:
                assert ratio <= 1.0 and rel <= BWD_REL_L2, name
            else:
                assert ratio > 10.0 and rel > 10 * BWD_REL_L2, name


def test_tf32x3_helpers_live_in_one_header():
    """K1, K4 and K5 include kernels/csrc/tf32x3.cuh (nvcc finds it by
    -I) and hash it into their libraries' names; no other header keeps a
    copy of the split."""
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    shared = common.SHARED_CSRC / "tf32x3.cuh"
    assert shared.is_file()
    for mod, header in ((ops, ops.HEADER), (wkv_ops, wkv_ops.HEADERS[0]),
                        (ssd_ops, ssd_ops.HEADERS[0])):
        assert shared in mod.HEADERS
        assert '#include "tf32x3.cuh"' in header.read_text()
    kernels = common.SHARED_CSRC.parent
    copies = [p for p in kernels.rglob("*.cu*")
              if "cvt.rna.tf32.f32" in p.read_text()]
    assert copies == [shared]


def test_edge_fault_anchors_occur_once():
    """scripts/k1_edge_fault.py plants its ragged-key-edge faults (one in
    the bf16 wgmma kernel, one in the float32 TF32 x 3 kernel) by
    replacing text that occurs exactly once in the forward source."""
    import importlib.util
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "k1_edge_fault", root / "scripts" / "k1_edge_fault.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = ops.SOURCE.read_text()
    assert len(mod.FAULTS) == 2
    for old, new in mod.FAULTS:
        assert text.count(old) == 1 and old != new, old


def test_ptxas_report_outlives_the_build(tmp_path, monkeypatch):
    """chip_smoke.py reads each TF32 kernel's spills from the build's ptxas
    report: a process that loads a library built earlier (by a test or a
    script in the same checkout) reads the report saved beside it."""
    import subprocess
    report = "ptxas info    : 0 bytes spill stores, 0 bytes spill loads\n"
    calls = []

    def nvcc(cmd, **kw):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", report)
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(common, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(common.subprocess, "run", nvcc)
    monkeypatch.setattr(common.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(common, "_libs", {})
    monkeypatch.setattr(common, "build_log", {})
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    common.load_library("k", [src])
    assert len(calls) == 1 and common.build_log["k"]["ptxas"] == report
    assert str(common.SHARED_CSRC) == calls[0][calls[0].index("-I") + 1]
    monkeypatch.setattr(common, "_libs", {})    # a new process
    common.build_log.clear()
    common.load_library("k", [src])
    assert len(calls) == 1 and common.build_log["k"]["ptxas"] == report


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _whisper_inputs(B, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, H, K, hd = (WHISPER[x] for x in ("S", "H", "K", "hd"))
    q = torch.randn(B, S, H, hd, generator=g, device="cuda")
    k = torch.randn(B, S, K, hd, generator=g, device="cuda") + KEY_SHIFT
    v = torch.randn(B, S, K, hd, generator=g, device="cuda")
    do = torch.randn(B, S, H, hd, generator=g, device="cuda")
    return q, k, v, do


def _reference64(q, k, v, do):
    """Non-causal attention (K = H here) and its gradients in float64."""
    q, k, v, do = (t.double().transpose(1, 2) for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, -1)
    o = p @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    grads = (ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
             p.transpose(-1, -2) @ do)
    return o.transpose(1, 2), [g.transpose(1, 2) for g in grads]


@pytest.mark.gpu
def test_forward_on_tensor_cores_at_whisper(cuda):
    q, k, v, _ = _whisper_inputs(8)
    out = flash_attention(q, k, v, causal=False)
    assert flash_attention.tensor_cores is True
    again = flash_attention(q, k, v, causal=False)
    plain = flash_attention_plain(q, k, v, causal=False)
    ref, _ = _reference64(q, k, v, q)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert _tol_ratio(out, plain.double()) <= 1.0
    assert _tol_ratio(out, ref) <= 1.0


@pytest.mark.gpu
def test_backward_on_tensor_cores_at_whisper(cuda):
    q, k, v, do = _whisper_inputs(2, seed=1)
    lengths = None
    o, lse = ops._forward(q, k, v, False, None, lengths, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    assert flash_attention_bwd.tensor_cores is True
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False)
    _, ref = _reference64(q, k, v, do)
    torch.cuda.synchronize()
    for name, a, b, p, r in zip(("dq", "dk", "dv"), got, again, plain, ref):
        assert torch.equal(a, b), name
        for want in (p.double(), r):
            assert _tol_ratio(a, want) <= 1.0, name
            rel = float((a.double() - want).norm() / want.norm())
            assert rel <= BWD_REL_L2, (name, rel)
