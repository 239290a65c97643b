"""The port's paged flash-decode (K3) against the JAX package's.

CPU cases: the same numpy inputs — a contiguous cache scattered into a
page pool by a numpy permutation — through the JAX
``paged_decode_attention`` (Pallas, interpret mode) and
``paged_decode_attention_oracle`` and through the port's wrapper on CPU
tensors (its plain version), on the parameter grid of
tests/test_kernels.py::test_paged_decode_attention, with its tolerances:
fp32 2e-5 (the sides sum in different orders), bf16 3e-2 (the Pallas
kernel keeps P in fp32, the plain version rounds it to bf16).  Rows have
length >= 1: a length-0 row gets zeros from the kernels and a uniform
average from the masked-softmax references.

GPU cases (marker ``gpu``, skipped without a CUDA device): the Hopper
kernel against the plain version on the card at the same tolerances, and
bit for bit against K2 on the gathered cache at page size 16; on an e4m3
pool (bf16 q), within 3e-2 of the plain version, bit for bit K3 on the
pool's bf16 copy and, at page size 16, K2 on the gathered e4m3 cache;
and P kept at fp32 precision, as the TPU kernel keeps it: on near-tied
scores over values of mixed sign and magnitude scattered into a pool,
every output within one bf16 ulp of a float64 computation on the same
inputs, where P rounded to bf16 moves outputs by several.  They need no
JAX.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain)
from repro_torch.kernels.decode_attention.ops import (paged_split_plan,
                                                      split_plan)
from repro_torch.models import attention as tattn
from repro_torch.models import paged as tpaged


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

# tests/test_kernels.py::test_paged_decode_attention's grid
GRID = [(4, 256, 8, 2, 64, 64, None), (2, 512, 8, 8, 128, 128, None),
        (3, 256, 4, 1, 64, 32, 64), (2, 1024, 16, 2, 128, 256, 256),
        (1, 96, 4, 2, 32, 16, 20)]


@pytest.fixture(scope="module")
def jax_pda():
    """The JAX package's paged decode attention (wrapper, oracle)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import paged_decode_attention
    from repro.kernels.decode_attention.ref import (
        paged_decode_attention_oracle)
    return paged_decode_attention, paged_decode_attention_oracle, jnp


def paged_inputs(B, Smax, H, K, hd, ps, seed=0, layers=1):
    """q, a contiguous cache, and the same cache scattered into a pool of
    B*MP + 1 pages (page 0 the dump page, holding noise) by a numpy
    permutation; lengths in [1, Smax]."""
    rng = np.random.default_rng(seed)
    MP = Smax // ps
    P = B * MP + 1
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    ck = rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
    cv = rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
    table = (1 + rng.permutation(P - 1)).reshape(B, MP).astype(np.int32)
    kp = rng.standard_normal((layers, P, ps, K, hd)).astype(np.float32)
    vp = rng.standard_normal((layers, P, ps, K, hd)).astype(np.float32)
    kp[layers // 2, table.reshape(-1)] = ck.reshape(B * MP, ps, K, hd)
    vp[layers // 2, table.reshape(-1)] = cv.reshape(B * MP, ps, K, hd)
    lengths = rng.integers(1, Smax + 1, (B,)).astype(np.int32)
    if layers == 1:
        kp, vp = kp[0], vp[0]
    return q, ck, cv, kp, vp, table, lengths


def _jax_in(jnp, x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


def _torch_in(x, dtype, device="cpu"):
    return torch.from_numpy(x).to(device, getattr(torch, dtype))


def _tol(dtype):
    return TOL32 if dtype == "float32" else TOL16


@pytest.mark.parametrize("B,Smax,H,K,hd,ps,window", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(jax_pda, B, Smax, H, K, hd, ps, window,
                                  dtype):
    jpda, _, jnp = jax_pda
    q, _, _, kp, vp, table, lengths = paged_inputs(B, Smax, H, K, hd, ps)
    want = jpda(*(_jax_in(jnp, x, dtype) for x in (q, kp, vp)),
                jnp.asarray(table), jnp.asarray(lengths), window=window)
    got = paged_decode_attention(
        *(_torch_in(x, dtype) for x in (q, kp, vp)),
        torch.from_numpy(table), torch.from_numpy(lengths), window=window)
    assert got.dtype == getattr(torch, dtype)
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    **_tol(dtype))


@pytest.mark.parametrize("B,Smax,H,K,hd,ps,window", GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle(jax_pda, B, Smax, H, K, hd, ps, window,
                                  dtype):
    """The gathered-view oracle with the default ``attn_dtype`` path: both
    sides round P to the cache dtype."""
    _, joracle, jnp = jax_pda
    q, _, _, kp, vp, table, lengths = paged_inputs(B, Smax, H, K, hd, ps,
                                                   seed=1)
    want = joracle(*(_jax_in(jnp, x, dtype) for x in (q, kp, vp)),
                   jnp.asarray(table), jnp.asarray(lengths), window=window)
    got = paged_decode_attention_plain(
        *(_torch_in(x, dtype) for x in (q, kp, vp)),
        torch.from_numpy(table), torch.from_numpy(lengths), window=window)
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    **_tol(dtype))


def test_gather_view_is_bitwise_dense():
    """tests/test_kernels.py::test_paged_oracle_gather_is_bitwise_dense:
    masked lanes contribute exact zeros, so the physical page order cannot
    perturb the math."""
    q, ck, cv, kp, vp, table, _ = paged_inputs(2, 128, 4, 2, 64, 32)
    lengths = torch.tensor([97, 31], dtype=torch.int32)
    paged = paged_decode_attention(*map(torch.from_numpy, (q, kp, vp,
                                                           table)), lengths)
    dense = decode_attention_plain(*map(torch.from_numpy, (q, ck, cv)),
                                   lengths)
    assert torch.equal(paged, dense)
    gk, gv = tpaged._gathered_view(torch.from_numpy(kp),
                                   torch.from_numpy(vp),
                                   torch.from_numpy(table))
    assert torch.equal(gk, torch.from_numpy(ck))
    assert torch.equal(gv, torch.from_numpy(cv))


def test_dump_page_rows_finite(jax_pda):
    """A vacant slot's table row is all zeros (the dump page): whatever
    lives there, the row's output stays finite and equals JAX's."""
    jpda, _, jnp = jax_pda
    q, _, _, kp, vp, table, _ = paged_inputs(2, 64, 4, 2, 32, 16, seed=4)
    table[1] = 0                             # row 1 parked on the dump page
    lengths = np.array([40, 1], np.int32)
    got = paged_decode_attention(*map(torch.from_numpy,
                                      (q, kp, vp, table, lengths)))
    assert torch.isfinite(got).all()
    want = jpda(*map(jnp.asarray, (q, kp, vp, table, lengths)))
    assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_rejects_bad_window_and_mixed_devices():
    q, _, _, kp, vp, table, lengths = (torch.from_numpy(x) for x in
                                       paged_inputs(1, 32, 2, 1, 32, 16))
    with pytest.raises(ValueError):
        paged_decode_attention(q, kp, vp, table, lengths, window=0)
    with pytest.raises(ValueError):
        paged_decode_attention(q.to("meta"), kp, vp, table, lengths)


@pytest.mark.parametrize("B,K,G,MP,ps,hd,sms", [
    (8, 4, 8, 64, 16, 128, 132),        # yi-9b tick: K2's plan unchanged
    (8, 4, 8, 2048, 16, 128, 132),      # 32k keys per row
    (8, 4, 8, 32, 32, 128, 132),
    (8, 4, 8, 16, 64, 128, 132),
    (4, 8, 4, 40, 16, 80, 132),
    (1, 1, 1, 7, 48, 64, 132),          # ps not a power of two
    (2, 8, 12, 44, 16, 128, 132),       # G=12: one block per group
])
@pytest.mark.parametrize("tc", [True, False])
def test_paged_split_plan(B, K, G, MP, ps, hd, sms, tc):
    """Splits start on page boundaries and cover every key; at ps = 16 the
    plan is K2's, so K3 walks K2's keys in K2's order (on either kernel)."""
    nsplit, chunk = paged_split_plan(B, K, G, MP, ps, hd, sms, tc)
    Smax = MP * ps
    assert chunk % ps == 0
    assert nsplit * chunk >= Smax > (nsplit - 1) * chunk
    if ps == 16:
        assert (nsplit, chunk) == split_plan(B, K, G, Smax, hd, sms, tc)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # name, B, Smax, H, K, hd, ps, window
    ("yi-9b tick shape", 8, 1024, 32, 4, 128, 16, None),
    ("window 100", 8, 1024, 32, 4, 128, 16, 100),
    ("danube hd=80 G=4", 4, 512, 32, 8, 80, 16, 300),
    ("hd=256", 2, 320, 8, 2, 256, 16, None),
    ("ps=32", 8, 1024, 32, 4, 128, 32, None),
    ("ps=64", 8, 1024, 32, 4, 128, 64, None),
    ("ps=48 (not a power of two)", 3, 480, 32, 4, 128, 48, None),
    ("hd=32 G=1", 3, 64, 4, 4, 32, 16, None),
    ("G=12 in one block", 2, 704, 96, 8, 128, 16, None),
    ("zamba2 hd=80 G=1", 8, 1024, 32, 32, 80, 16, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Smax,H,K,hd,ps,window", GPU_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(cuda, name, B, Smax, H, K, hd, ps,
                                     window, dtype):
    q, _, _, kp, vp, table, lengths = paged_inputs(B, Smax, H, K, hd, ps)
    q, kp, vp = (_torch_in(x, dtype, cuda) for x in (q, kp, vp))
    table, lengths = (torch.from_numpy(x).to(cuda) for x in (table,
                                                              lengths))
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, table, lengths, window=window)
    want = paged_decode_attention_plain(q, kp, vp, table, lengths,
                                        window=window)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("Smax", [1024, 32768])
def test_kernel_is_bitwise_k2_at_page_size_16(cuda, dtype, window, Smax):
    """At ps = 16 K3 takes K2's split plan and walks the same keys in the
    same order: its output on the pool equals K2's on the gathered cache
    bit for bit (shared pages and a vacant row included), at the tick
    shape and at 32k keys per row."""
    B, H, K, hd, ps = 8, 32, 4, 128, 16
    q, _, _, kp, vp, table, lengths = paged_inputs(B, Smax, H, K, hd, ps,
                                                   seed=5)
    table[1:4, :4] = table[0, :4]            # rows 0-3 share their prefix
    table[7] = 0                             # a vacant row on the dump page
    lengths[7] = 1
    q, kp, vp = (_torch_in(x, dtype, cuda) for x in (q, kp, vp))
    table, lengths = (torch.from_numpy(x).to(cuda) for x in (table,
                                                              lengths))
    got = paged_decode_attention(q, kp, vp, table, lengths, window=window)
    gk, gv = tpaged._gathered_view(kp, vp, table)
    want = decode_attention(q, gk, gv, lengths, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_reads_a_layer_view_of_the_stacked_pool(cuda, dtype):
    """A (P,ps,K,hd) layer view of an (L,P,ps,K,hd) pool, read through
    strides, no copy."""
    q, _, _, kp, vp, table, lengths = paged_inputs(4, 384, 16, 2, 128, 16,
                                                   seed=3, layers=3)
    q, kp, vp = (_torch_in(x, dtype, cuda) for x in (q, kp, vp))
    table, lengths = (torch.from_numpy(x).to(cuda) for x in (table,
                                                              lengths))
    got = paged_decode_attention(q, kp[1], vp[1], table, lengths)
    want = paged_decode_attention_plain(q, kp[1], vp[1], table, lengths)
    torch.cuda.synchronize()
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **_tol(dtype))


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 2, 64), device=cuda)
    pool = torch.zeros((3, 16, 1, 64), device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    lengths = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention(q, pool, pool, table.long(), lengths)
    with pytest.raises(ValueError, match="shape"):
        paged_decode_attention(q, pool, pool, table.expand(2, 2), lengths)
    with pytest.raises(TypeError):
        paged_decode_attention(q.half(), pool.half(), pool.half(), table,
                               lengths)


# --- the e4m3 pool on the card -------------------------------------------------


def e4m3_pool(x, device):
    """An e4m3 pool reaching the format's edges (near +-448, subnormals),
    cast as the port's page writes cast (``attention.to_cache``)."""
    x = x * 3.0
    x.reshape(-1)[::97] = 440.0
    x.reshape(-1)[1::89] = -448.0
    x.reshape(-1)[2::7] *= 2 ** -9
    return tattn.to_cache(torch.from_numpy(x).bfloat16(),
                          torch.float8_e4m3fn).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,Smax,H,K,hd,ps,window", GPU_CASES)
def test_e4m3_kernel_matches_plain_on_gpu(cuda, name, B, Smax, H, K, hd, ps,
                                          window):
    """K3 on an e4m3 pool: within TOL16 of the plain version and bit for
    bit K3 on the pool's bf16 copy."""
    q, _, _, kp, vp, table, lengths = paged_inputs(B, Smax, H, K, hd, ps)
    q = _torch_in(q, "bfloat16", cuda)
    kp, vp = e4m3_pool(kp, cuda), e4m3_pool(vp, cuda)
    table, lengths = (torch.from_numpy(x).to(cuda) for x in (table,
                                                              lengths))
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, table, lengths, window=window)
    assert paged_decode_attention.launches == before + 1
    copy = paged_decode_attention(q, kp.bfloat16(), vp.bfloat16(), table,
                                  lengths, window=window)
    want = paged_decode_attention_plain(q, kp, vp, table, lengths,
                                        window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, copy)
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    **_tol("bfloat16"))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 100])
def test_e4m3_kernel_is_bitwise_k2_at_page_size_16(cuda, window):
    """At ps = 16 K3 on an e4m3 pool equals K2 on the gathered e4m3 cache
    bit for bit (shared pages and a vacant row included), on a layer view
    of a stacked pool."""
    B, Smax, H, K, hd, ps = 8, 1024, 32, 4, 128, 16
    q, _, _, kp, vp, table, lengths = paged_inputs(B, Smax, H, K, hd, ps,
                                                   seed=5, layers=3)
    table[1:4, :4] = table[0, :4]
    table[7] = 0
    lengths[7] = 1
    q = _torch_in(q, "bfloat16", cuda)
    kp, vp = e4m3_pool(kp, cuda)[1], e4m3_pool(vp, cuda)[1]
    table, lengths = (torch.from_numpy(x).to(cuda) for x in (table,
                                                              lengths))
    got = paged_decode_attention(q, kp, vp, table, lengths, window=window)
    gk, gv = tpaged._gathered_view(kp, vp, table)
    assert gk.dtype == torch.float8_e4m3fn
    want = decode_attention(q, gk, gv, lengths, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# --- P at fp32 precision ------------------------------------------------------


def near_tie_pool(seed, cache_dtype, device, B=2, H=8, K=1, hd=128, ps=8,
                  MP=3):
    """q, the pool, page table and lengths of near-tied scores over v of
    +-64 in balanced halves plus 0 or 8 (exact in bf16 and e4m3), each
    row's keys on shuffled pages of size ``ps``, so that P's rounding to
    bf16 shows (test_torch_decode_attention.py::near_tie_case), with the
    gathered (B, MP * ps, K, hd) cache for the reference."""
    rng = np.random.default_rng(seed)
    Smax = MP * ps
    q = np.zeros((B, H, hd), np.float32)
    q[..., 0] = rng.uniform(0.5, 2.0, (B, H))
    q[..., 1] = rng.uniform(-1.0, 1.0, (B, H))
    k = np.zeros((B, Smax, K, hd), np.float32)
    k[..., :2] = rng.integers(-4, 5, (B, Smax, K, 2)) * 0.125
    order = np.argsort(rng.random((B, Smax, K, hd)), axis=1)
    v = (np.where(order % 2 == 0, 64.0, -64.0)
         + 8.0 * (rng.random((B, Smax, K, hd)) < 0.5)).astype(np.float32)
    table = (1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)
    pools = []
    for t in (k, v):
        pool = np.zeros((B * MP + 1, ps, K, hd), np.float32)
        pool[table.reshape(-1)] = t.reshape(B * MP, ps, K, hd)
        pool = torch.from_numpy(pool).bfloat16()
        if cache_dtype == "float8_e4m3fn":
            pool = tattn.to_cache(pool, torch.float8_e4m3fn)
        pools.append(pool.to(device))
    lengths = torch.full((B,), Smax, dtype=torch.int32, device=device)
    q = torch.from_numpy(q).to(device, torch.bfloat16)
    table = torch.from_numpy(table).to(device)
    gathered = [p[table.long()].reshape(B, Smax, K, hd) for p in pools]
    return q, pools, table, lengths, gathered


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float8_e4m3fn"])
def test_p_keeps_fp32_precision_on_gpu(cuda, cache_dtype, seed):
    """K3's tensor-core kernel takes P as bf16 hi + lo parts: every output
    within one bf16 ulp of float64 attention over the gathered cache (the
    final rounding alone is half an ulp)."""
    q, (kp, vp), table, lengths, (k, v) = near_tie_pool(seed, cache_dtype,
                                                        cuda)
    got = paged_decode_attention(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    B, H, hd = q.shape
    G = H // k.shape[2]
    qd, kd, vd = (t.cpu().double() for t in (q, k, v))
    want = torch.zeros((B, H, hd), dtype=torch.float64)
    for b in range(B):
        n = int(lengths[b])
        for h in range(H):
            p = torch.softmax(kd[b, :n, h // G] @ qd[b, h] / hd ** 0.5, 0)
            want[b, h] = p @ vd[b, :n, h // G]
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
    ulps = (got.cpu().double() - want).abs() / ulp
    assert float(ulps.max()) <= 1.0, float(ulps.max())
