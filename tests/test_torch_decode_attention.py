"""The port's flash-decode (K2) against the JAX package's.

CPU cases: the same numpy inputs through the JAX ``decode_attention``
(Pallas, interpret mode) and ``decode_attention_ref`` and through the
port's wrapper on CPU tensors (its plain version), on the parameter grid
of tests/test_kernels.py::test_decode_attention, with its tolerances:
fp32 2e-5 (the sides sum in different orders), bf16 3e-2 (the Pallas
kernel keeps P in fp32, the plain version rounds it to bf16).  Only rows
of length >= 1 are compared: a length-0 row gets zeros from the kernels
and a uniform average from the masked-softmax references.

GPU cases (marker ``gpu``, skipped without a CUDA device): the Hopper
kernel against the plain version on the card at the same tolerances; on
an e4m3 cache (bf16 q) within 3e-2 of the plain version and bit for bit
the kernel on the cache's bf16 copy; and P kept at fp32 precision, as the
TPU kernel keeps it: on near-tied scores over values of mixed sign and
magnitude, every output within one bf16 ulp of a float64 computation on
the same bf16 (or e4m3) inputs, where P rounded to bf16 moves outputs by
several.  They need no JAX.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.decode_attention.ops import (heads_per_block,
                                                      split_plan,
                                                      tensor_core_path)
from repro_torch.models import attention as tattn


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


TOL32 = dict(rtol=2e-5, atol=2e-5)
TOL16 = dict(rtol=3e-2, atol=3e-2)

# tests/test_kernels.py::test_decode_attention's grid
GRID = [(4, 256, 8, 2, 64, None), (2, 512, 8, 8, 128, None),
        (3, 300, 4, 1, 64, 64), (2, 1024, 16, 2, 128, 256)]


@pytest.fixture(scope="module")
def jax_da():
    """The JAX package's decode attention (wrapper, model-layer oracle)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import decode_attention as jda
    from repro.models.attention import decode_attention_ref as jref
    return jda, jref, jnp


def _inputs(B, Smax, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    ck = rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
    lengths = rng.integers(1, Smax, (B,)).astype(np.int32)
    return q, ck, cv, lengths


def _jax_in(jnp, x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


def _torch_in(x, dtype, device="cpu"):
    return torch.from_numpy(x).to(device, getattr(torch, dtype))


@pytest.mark.parametrize("B,Smax,H,K,hd,window", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(jax_da, B, Smax, H, K, hd, window, dtype):
    jda, _, jnp = jax_da
    q, ck, cv, lengths = _inputs(B, Smax, H, K, hd)
    want = jda(*(_jax_in(jnp, x, dtype) for x in (q, ck, cv)),
               jnp.asarray(lengths), window=window, kv_blk=128)
    got = decode_attention(*(_torch_in(x, dtype) for x in (q, ck, cv)),
                           torch.from_numpy(lengths), window=window)
    assert got.dtype == getattr(torch, dtype)
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    **(TOL32 if dtype == "float32" else TOL16))


@pytest.mark.parametrize("B,Smax,H,K,hd,window", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_ref(jax_da, B, Smax, H, K, hd, window, dtype):
    """The model layer's oracle, ``jattn.decode_attention_ref``, with the
    default ``attn_dtype`` path: both sides round P to the cache dtype."""
    _, jref, jnp = jax_da
    q, ck, cv, lengths = _inputs(B, Smax, H, K, hd, seed=1)
    want = jref(*(_jax_in(jnp, x, dtype) for x in (q, ck, cv)),
                jnp.asarray(lengths), window=window)
    got = tattn.decode_attention_ref(
        *(_torch_in(x, dtype) for x in (q, ck, cv)),
        torch.from_numpy(lengths), window=window)
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    **(TOL32 if dtype == "float32" else TOL16))


def test_length_one_rows_attend_to_their_token(jax_da):
    """tests/test_kernels.py::test_decode_attention_empty_rows: a length-1
    row attends only to slot 0 and returns its value row."""
    jda, _, jnp = jax_da
    q, ck, cv, _ = _inputs(2, 64, 4, 2, 32, seed=2)
    lengths = np.array([1, 2], np.int32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                           torch.from_numpy(cv), torch.from_numpy(lengths))
    want = jda(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
               jnp.asarray(lengths), kv_blk=32)
    assert torch.isfinite(got).all()
    assert_allclose(got.numpy(), np.asarray(want), **TOL32)
    assert_allclose(got[0].numpy(), np.repeat(cv[0, 0], 2, axis=0), **TOL32)


def test_rejects_bad_window_and_mixed_devices():
    q, ck, cv, lengths = (torch.from_numpy(x) for x in
                          _inputs(1, 8, 2, 1, 32))
    with pytest.raises(ValueError):
        decode_attention(q, ck, cv, lengths, window=0)
    with pytest.raises(ValueError):
        decode_attention(q.to("meta"), ck, cv, lengths)


@pytest.mark.parametrize("B,K,G,Smax,hd,sms,tc,want", [
    # tensor cores: one block per (split, KV head, row), two per SM
    (8, 4, 8, 1024, 128, 132, True, (8, 128)),       # yi-9b serving shape
    (8, 4, 8, 32768, 128, 132, True, (8, 4096)),     # long cache: one wave
    (1, 1, 1, 100, 64, 132, True, (2, 64)),
    (4, 8, 12, 4096, 128, 132, True, (8, 512)),      # G=12 in one block
    (8, 32, 1, 1024, 80, 132, True, (1, 1024)),      # zamba2's shared block
    # CUDA cores (fp32, hd 256): head groups of <= 8, three blocks per SM
    (8, 4, 8, 1024, 128, 132, False, (11, 96)),
    (8, 4, 8, 32768, 128, 132, False, (12, 2736)),
    (1, 1, 1, 100, 64, 132, False, (2, 64)),
    (4, 8, 12, 4096, 128, 132, False, (6, 688)),     # G=12: two head groups
])
def test_split_plan(B, K, G, Smax, hd, sms, tc, want):
    """The KV split depends on shapes only; every key lies in a split."""
    nsplit, chunk = split_plan(B, K, G, Smax, hd, sms, tc)
    assert (nsplit, chunk) == want
    assert nsplit * chunk >= Smax > (nsplit - 1) * chunk


def test_heads_per_block():
    """Tensor cores serve the whole group (up to 16 heads, the rows of the
    A tile) in one block; CUDA cores a power of two up to 8 (4 past hd
    128)."""
    assert heads_per_block(12, 128, True) == 16
    assert heads_per_block(1, 80, True) == 16
    assert heads_per_block(12, 128, False) == 8
    assert heads_per_block(16, 256, False) == 4
    assert heads_per_block(4, 80, False) == 4
    assert heads_per_block(3, 64, False) == 4


@pytest.mark.parametrize("dtype,hd,G,offset,want", [
    (torch.bfloat16, 128, 8, 0, True),
    (torch.bfloat16, 80, 1, 0, True),
    (torch.bfloat16, 128, 12, 0, True),
    (torch.bfloat16, 256, 4, 0, False),      # hd 256: CUDA cores
    (torch.bfloat16, 128, 32, 0, False),     # G above 16
    (torch.bfloat16, 128, 8, 4, False),      # rows 8 bytes off 16
    (torch.float32, 128, 8, 0, False),
])
def test_tensor_core_path(dtype, hd, G, offset, want):
    """Which launches the tensor-core split kernel takes."""
    K = 2
    q = torch.zeros((2, K * G, hd + offset), dtype=dtype)[..., offset:]
    c = torch.zeros((2, 8, K, hd + offset), dtype=dtype)[..., offset:]
    assert tensor_core_path(q, c, c) is want


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # name, B, Smax, H, K, hd, window, lengths ("ragged" | "ring" | "one")
    ("yi-9b serving shape", 8, 1024, 32, 4, 128, None, "ragged"),
    ("window 100", 8, 1024, 32, 4, 128, 100, "ragged"),
    ("ring lengths min(L+1,Smax)", 8, 256, 32, 4, 128, None, "ring"),
    ("length-1 rows", 4, 128, 32, 4, 128, None, "one"),
    ("Smax 1000 (ragged tile)", 3, 1000, 32, 4, 128, None, "ragged"),
    ("danube hd=80 G=4", 4, 512, 32, 8, 80, 300, "ragged"),
    ("G=12", 2, 700, 96, 8, 128, None, "ragged"),
    ("G=12 in one block, window 300", 4, 2048, 96, 8, 128, 300, "ragged"),
    ("zamba2 hd=80 G=1 ring", 8, 1024, 32, 32, 80, None, "ring"),
    ("hd=256", 2, 300, 8, 2, 256, None, "ragged"),
    ("hd=32 G=1", 3, 64, 4, 4, 32, None, "ragged"),
]


def gpu_case_lengths(kind, B, Smax, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "one":
        return np.ones((B,), np.int32)
    if kind == "ring":              # some rows wrapped, some not yet
        L = rng.integers(0, 3 * Smax, (B,))
        return np.minimum(L + 1, Smax).astype(np.int32)
    lengths = rng.integers(1, Smax + 1, (B,)).astype(np.int32)
    lengths[0] = Smax
    return lengths


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Smax,H,K,hd,window,kind", GPU_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(cuda, name, B, Smax, H, K, hd, window,
                                     kind, dtype):
    q, ck, cv, _ = _inputs(B, Smax, H, K, hd)
    lengths = torch.from_numpy(gpu_case_lengths(kind, B, Smax)).to(cuda)
    q, ck, cv = (_torch_in(x, dtype, cuda) for x in (q, ck, cv))
    before = decode_attention.launches
    got = decode_attention(q, ck, cv, lengths, window=window)
    want = decode_attention_plain(q, ck, cv, lengths, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **(TOL32 if dtype == "float32" else TOL16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_reads_a_layer_view_of_the_stacked_cache(cuda, dtype):
    """A (B,Smax,K,hd) layer view of a (L,B,Smax,K,hd) cache, and a q that
    is a strided slice: read through strides, no copy."""
    L, B, Smax, H, K, hd = 3, 4, 384, 16, 2, 128
    rng = np.random.default_rng(3)
    ck = _torch_in(rng.standard_normal((L, B, Smax, K, hd)).astype(
        np.float32), dtype, cuda)
    cv = _torch_in(rng.standard_normal((L, B, Smax, K, hd)).astype(
        np.float32), dtype, cuda)
    q = _torch_in(rng.standard_normal((B, 1, H, 2 * hd)).astype(np.float32),
                  dtype, cuda)[:, 0, :, :hd]
    lengths = torch.tensor([384, 1, 200, 77], dtype=torch.int32, device=cuda)
    got = decode_attention(q, ck[1], cv[1], lengths)
    want = decode_attention_plain(q, ck[1], cv[1], lengths)
    torch.cuda.synchronize()
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **(TOL32 if dtype == "float32" else TOL16))


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 2, 512), device=cuda)
    c = torch.zeros((1, 8, 1, 512), device=cuda)
    lengths = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, c, c, lengths)
    with pytest.raises(TypeError):
        h = q[..., :64].half()
        decode_attention(h, c[..., :64].half(), c[..., :64].half(), lengths)
    with pytest.raises(ValueError, match="aligned"):   # rows 1 element off
        qb = torch.zeros((1, 2, 129), dtype=torch.bfloat16, device=cuda)
        cb = torch.zeros((1, 8, 1, 129), dtype=torch.bfloat16, device=cuda)
        decode_attention(qb[..., 1:], cb[..., 1:], cb[..., 1:], lengths)


# --- the e4m3 cache on the card ----------------------------------------------


def e4m3_cache(x, device):
    """An e4m3 cache from numpy values scaled to reach the format's edges
    (a share of keys near +-448, some e4m3 subnormals), cast as the port's
    cache writes cast (``attention.to_cache``)."""
    x = x * 3.0
    x.reshape(-1)[::97] = 440.0
    x.reshape(-1)[1::89] = -448.0
    x.reshape(-1)[2::7] *= 2 ** -9
    return tattn.to_cache(torch.from_numpy(x).bfloat16(),
                          torch.float8_e4m3fn).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Smax,H,K,hd,window,kind", GPU_CASES)
def test_e4m3_kernel_matches_plain_and_its_bf16_copy_on_gpu(
        cuda, name, B, Smax, H, K, hd, window, kind):
    """K2 reads an e4m3 cache directly: within TOL16 of the plain version
    (which dequantizes to bf16), and bit for bit K2 on the bf16 copy of
    the same cache (every e4m3 value is a bf16 value; same path, same
    split plan)."""
    q, ck, cv, _ = _inputs(B, Smax, H, K, hd)
    lengths = torch.from_numpy(gpu_case_lengths(kind, B, Smax)).to(cuda)
    q = _torch_in(q, "bfloat16", cuda)
    ck, cv = e4m3_cache(ck, cuda), e4m3_cache(cv, cuda)
    bk, bv = ck.bfloat16(), cv.bfloat16()
    assert tensor_core_path(q, ck, cv) == tensor_core_path(q, bk, bv)
    before = decode_attention.launches
    got = decode_attention(q, ck, cv, lengths, window=window)
    assert decode_attention.launches == before + 1
    copy = decode_attention(q, bk, bv, lengths, window=window)
    want = decode_attention_plain(q, ck, cv, lengths, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, copy)
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **TOL16)


@pytest.mark.gpu
def test_e4m3_kernel_reads_a_layer_view_and_strided_rows(cuda):
    """A layer view of a stacked e4m3 cache (no copy), and rows 8 bytes
    off 16 (the CUDA-core kernel)."""
    L, B, Smax, H, K, hd = 3, 4, 384, 16, 2, 128
    rng = np.random.default_rng(3)
    ck = e4m3_cache(rng.standard_normal((L, B, Smax, K, hd)).astype(
        np.float32), cuda)
    cv = e4m3_cache(rng.standard_normal((L, B, Smax, K, hd)).astype(
        np.float32), cuda)
    q = _torch_in(rng.standard_normal((B, H, hd)).astype(np.float32),
                  "bfloat16", cuda)
    lengths = torch.tensor([384, 1, 200, 77], dtype=torch.int32, device=cuda)
    for k, v, tc in ((ck[1], cv[1], True),
                     (ck[1, ..., 8:72], cv[1, ..., 8:72], False)):
        assert tensor_core_path(q[..., :k.shape[-1]], k, v) is tc
        qq = q[..., :k.shape[-1]]
        got = decode_attention(qq, k, v, lengths)
        want = decode_attention_plain(qq, k, v, lengths)
        copy = decode_attention(qq, k.bfloat16(), v.bfloat16(), lengths)
        torch.cuda.synchronize()
        assert torch.equal(got, copy) or not tc
        assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), **TOL16)


# --- P at fp32 precision ------------------------------------------------------


def near_tie_case(seed, cache_dtype, device, B=2, H=8, K=1, hd=128,
                  Smax=24):
    """q, k, v, lengths where rounding P to bf16 shows: scores q.k/sqrt(hd)
    a few hundredths apart (so every p lies in (0.9, 1], where bf16 keeps
    8 bits), v of +-64 in balanced halves plus 0 or 8 (an output of a few
    units from terms of 64: P's rounding error is amplified), every key
    valid (two 16-key tiles).  Every value is exact in bf16 and in
    e4m3."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, H, hd), np.float32)
    q[..., 0] = rng.uniform(0.5, 2.0, (B, H))
    q[..., 1] = rng.uniform(-1.0, 1.0, (B, H))
    k = np.zeros((B, Smax, K, hd), np.float32)
    k[..., :2] = rng.integers(-4, 5, (B, Smax, K, 2)) * 0.125
    order = np.argsort(rng.random((B, Smax, K, hd)), axis=1)
    v = (np.where(order % 2 == 0, 64.0, -64.0)
         + 8.0 * (rng.random((B, Smax, K, hd)) < 0.5)).astype(np.float32)
    q = torch.from_numpy(q).to(device, torch.bfloat16)
    k, v = (torch.from_numpy(t).bfloat16() for t in (k, v))
    if cache_dtype == "float8_e4m3fn":
        k, v = (tattn.to_cache(t, torch.float8_e4m3fn) for t in (k, v))
    lengths = torch.full((B,), Smax, dtype=torch.int32, device=device)
    return q, k.to(device), v.to(device), lengths


def decode_f64(q, k, v, lengths):
    """One-token GQA softmax attention in float64 on the CPU."""
    B, H, hd = q.shape
    G = H // k.shape[2]
    q, k, v = (t.cpu().double() for t in (q, k, v))
    out = torch.zeros((B, H, hd), dtype=torch.float64)
    for b in range(B):
        n = int(lengths[b])
        for h in range(H):
            p = torch.softmax(k[b, :n, h // G] @ q[b, h] / hd ** 0.5, 0)
            out[b, h] = p @ v[b, :n, h // G]
    return out


def bf16_ulps(got, want):
    """|got - want| in units of one bf16 ulp at |want| (want float64)."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
    return (got.cpu().double() - want).abs() / ulp


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float8_e4m3fn"])
def test_p_keeps_fp32_precision_on_gpu(cuda, cache_dtype, seed):
    """The tensor-core kernel takes P as bf16 hi + lo parts: every output
    within one bf16 ulp of float64 on the same inputs (the final rounding
    alone is half an ulp).  With P rounded to bf16 (the kernel before it
    took hi + lo parts) the largest miss of a seed was 3.4 to 8.6 ulps on
    an H100."""
    q, k, v, lengths = near_tie_case(seed, cache_dtype, cuda)
    assert tensor_core_path(q, k, v)
    got = decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    ulps = bf16_ulps(got, decode_f64(q, k, v, lengths))
    assert float(ulps.max()) <= 1.0, float(ulps.max())
