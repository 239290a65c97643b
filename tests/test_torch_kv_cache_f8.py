"""The fp8 e4m3 KV cache (``kv_cache_f8``) in the port against the JAX
package, on the CPU.

- The cast (``attention.to_cache``) against ``jnp.astype(float8_e4m3fn)``
  over all 65,536 bf16 bit patterns, byte for byte (NaN above the overflow
  edge, with the input's sign, where torch's own cast saturates).
- The plain K2 and K3 on e4m3 caches against JAX's
  ``decode_attention_ref`` / ``paged_decode_attention_oracle`` on the same
  e4m3 bytes, on tests/test_torch_decode_attention.py's grid, with values
  near +-448 and e4m3 subnormals in the cache.  Both dequantize to bf16
  and round P to bf16: 1e-2 (the outputs are bf16; one bf16 step).
- Decode-state dtypes under the flag equal JAX's: a bf16 GQA config's
  dense caches and page pools are e4m3; fp32 configs, MLA, hybrid, vlm and
  encdec caches keep the compute dtype.
- The cache bytes after a prefill's fill and three decode writes (dense
  and ring), a verify window and paged writes equal JAX's from the same
  bf16 K/V, byte for byte.
- A bf16 yi prefill and three decode steps under the flag against JAX's:
  logits within 5e-2 of their scale (XLA and torch round bf16 products
  differently, and the e4m3 cache then rounds a K/V that is one bf16 step
  apart to a neighbouring e4m3 value); caches within one e4m3 step
  (rtol 0.125) or 5e-2 of their scale (where a product cancels), and at
  least 90% of their bytes equal.
- Inside the port, on e4m3 caches: dense and paged scheduler streams
  equal, speculative and sequential streams equal, and a page costs half
  the bytes (as in JAX).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro import opt as jopt
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.engine import page_kv_bytes as jpage_kv_bytes
from repro.kernels.decode_attention.ref import paged_decode_attention_oracle
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import paged as jpaged
from repro.training.checkpoint import _flatten
from repro_torch import opt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (ContinuousBatchingScheduler, InferenceEngine,
                              PagedInferenceEngine, SamplingParams,
                              SpeculativeEngine, page_kv_bytes)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import paged as tpaged
from repro_torch.models import transformer as ttfm
from repro_torch.params import _to_tensor, from_jax, to_flat


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


E4M3 = torch.float8_e4m3fn
JE4M3 = jnp.float8_e4m3fn
BF16_OUT = dict(rtol=1e-2, atol=1e-2)
# K2's grid (tests/test_torch_decode_attention.py)
GRID = [(4, 256, 8, 2, 64, None), (2, 512, 8, 8, 128, None),
        (3, 300, 4, 1, 64, 64), (2, 1024, 16, 2, 128, 256)]


def _bits(x):
    return np.asarray(x).view(np.uint8)


def _extreme(rng, shape, scale=2.0):
    """Normal values with a share near +-448 (and past the edge: NaN in
    e4m3 only where asked) and of e4m3 subnormals (|x| < 2^-6)."""
    x = rng.standard_normal(shape).astype(np.float32) * scale
    pick = rng.random(shape)
    x[pick < 0.01] = rng.choice([-440.0, 416.0, 448.0, -448.0],
                                size=int((pick < 0.01).sum()))
    tiny = (pick > 0.97)
    x[tiny] = rng.uniform(-2 ** -7, 2 ** -7, int(tiny.sum()))
    return x


def _f8_pair(x):
    """The same e4m3 bytes as a JAX array and a torch tensor (cast from
    bf16 in JAX)."""
    j = jnp.asarray(x, jnp.bfloat16).astype(JE4M3)
    return j, _to_tensor(np.asarray(j))


def test_cast_matches_jax_over_every_bf16_pattern():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    want = _bits(jnp.asarray(bits.view(jnp.bfloat16)).astype(JE4M3))
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = tattn.to_cache(x, E4M3)
    assert got.dtype == E4M3
    g = got.view(torch.uint8).numpy()
    g_nan = np.isnan(got.float().numpy())
    w_nan = np.isnan(np.asarray(want.view(JE4M3), np.float32))
    assert (g_nan == w_nan).all()
    assert (g[~g_nan] == want[~w_nan]).all()
    assert (g == want).all()            # NaN's sign too
    # torch's own cast saturates where the reference gives NaN
    sat = x.to(E4M3).view(torch.uint8).numpy()
    over = np.abs(x.float().numpy()) > 464
    assert over.sum() and not np.isnan(
        x.to(E4M3)[torch.from_numpy(over)].float().numpy()).any()
    assert (sat[~over] == want[~over]).all()


@pytest.mark.parametrize("B,Smax,H,K,hd,window", GRID)
def test_plain_k2_on_e4m3_matches_jax(B, Smax, H, K, hd, window):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    jk, tk = _f8_pair(_extreme(rng, (B, Smax, K, hd)))
    jv, tv = _f8_pair(_extreme(rng, (B, Smax, K, hd)))
    lengths = rng.integers(1, Smax, (B,)).astype(np.int32)
    ref = jax.jit(functools.partial(jattn.decode_attention_ref,
                                    window=window))
    want = ref(jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(lengths))
    got = decode_attention(torch.from_numpy(q).bfloat16(), tk, tv,
                           torch.from_numpy(lengths), window=window)
    assert got.dtype == torch.bfloat16
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    **BF16_OUT)


@pytest.mark.parametrize("B,Smax,H,K,hd,ps,window", [
    (4, 256, 8, 2, 64, 64, None), (3, 256, 4, 1, 64, 32, 64),
    (1, 96, 4, 2, 32, 16, 20)])
def test_plain_k3_on_e4m3_matches_jax(B, Smax, H, K, hd, ps, window):
    rng = np.random.default_rng(1)
    MP = Smax // ps
    P = B * MP + 1
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    jkp, tkp = _f8_pair(_extreme(rng, (P, ps, K, hd)))
    jvp, tvp = _f8_pair(_extreme(rng, (P, ps, K, hd)))
    table = (1 + rng.permutation(P - 1)).reshape(B, MP).astype(np.int32)
    lengths = rng.integers(1, Smax + 1, (B,)).astype(np.int32)
    ref = jax.jit(functools.partial(paged_decode_attention_oracle,
                                    window=window))
    want = ref(jnp.asarray(q, jnp.bfloat16), jkp, jvp, jnp.asarray(table),
               jnp.asarray(lengths))
    got = paged_decode_attention(torch.from_numpy(q).bfloat16(), tkp, tvp,
                                 torch.from_numpy(table),
                                 torch.from_numpy(lengths), window=window)
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    **BF16_OUT)


# --- decode-state dtypes ---------------------------------------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _dtypes(tree):
    return {k: str(v.dtype).removeprefix("torch.")
            for k, v in _leaves(tree)}


@pytest.mark.parametrize("arch,bf16,f8_leaves", [
    ("yi-9b", True, {"cache/k", "cache/v"}),
    ("yi-9b", False, set()),
    ("deepseek-v3-671b", True, set()),          # MLA: compute dtype
    ("zamba2-2.7b", True, set()),
    ("llama-3.2-vision-11b", True, set()),
    ("whisper-base", True, set())])
def test_state_dtypes_match_jax_under_the_flag(arch, bf16, f8_leaves):
    jcfg, tcfg = jreduce(jget_config(arch)), reduce_for_smoke(get_config(
        arch))
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    with jopt.flags(kv_cache_f8=True):
        want = _dtypes(jbuild(jcfg).init_state(2, 32))
    with opt.flags(kv_cache_f8=True):
        got = _dtypes(build_model(tcfg).init_state(2, 32, device="meta"))
    assert got == want
    assert {k for k, d in got.items() if d == "float8_e4m3fn"} == f8_leaves
    if arch == "yi-9b":
        with jopt.flags(kv_cache_f8=True):
            want = _dtypes(jpaged.init_paged_state(jcfg, 2, 9, 16, 4))
        with opt.flags(kv_cache_f8=True):
            got = _dtypes(tpaged.init_paged_state(tcfg, 2, 9, 16, 4,
                                                  device="meta"))
        assert got == want


def test_page_kv_bytes_halves_as_in_jax():
    for arch in ("yi-9b", "qwen3-moe-235b-a22b"):
        jcfg = dataclasses.replace(jget_config(arch), dtype="bfloat16")
        tcfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
        base = page_kv_bytes(tcfg, 16)
        with jopt.flags(kv_cache_f8=True):
            want = jpage_kv_bytes(jcfg, 16)
        with opt.flags(kv_cache_f8=True):
            got = page_kv_bytes(tcfg, 16)
        assert got == want == base // 2
    # yi-9b: 48 layers x 16 keys x 4 heads x 128 dims x 2 (k, v) bytes
    assert page_kv_bytes(get_config("yi-9b"), 16) == \
        48 * 16 * 4 * 128 * 2 * 2


# --- cache bytes from the same bf16 K/V --------------------------------------


def _kv(rng, B, T, K, hd):
    x = _extreme(rng, (B, T, K, hd), scale=60.0)
    x[0, 1, 0, :3] = [500.0, -470.0, 1e5]             # past the edge: NaN
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _same_bytes(tc, jc):
    assert tc.dtype == E4M3
    assert (tc.view(torch.uint8).numpy() == _bits(jc)).all()


@pytest.mark.parametrize("ring", [False, True])
def test_cache_bytes_after_prefill_and_three_decodes_match_jax(ring):
    rng = np.random.default_rng(4)
    B, S, Smax, K, hd = 2, 9, (8 if ring else 16), 2, 8
    jkv, tkv = _kv(rng, B, S + 3, K, hd)
    lens = np.array([S, 6], np.int32)
    # JAX: transformer.prefill's fill, then decode_attn_block's writes
    if ring:
        jc = jattn.ring_fill(jkv[:, :S], jnp.asarray(lens), Smax).astype(
            JE4M3)
    else:
        jc = jnp.pad(jkv[:, :S], [(0, 0), (0, Smax - S), (0, 0),
                                  (0, 0)]).astype(JE4M3)
    tc = torch.zeros((B, Smax, K, hd), dtype=E4M3)
    tattn.fill_cache(tc, tkv[:, :S], torch.from_numpy(lens), ring)
    _same_bytes(tc, jc)
    for t in range(3):
        jl, tl = jnp.asarray(lens + t), torch.from_numpy(lens + t)
        new_j, new_t = jkv[:, S + t:S + t + 1], tkv[:, S + t:S + t + 1]
        if ring:
            jc, _ = jattn.ring_write(jc, jc, new_j, new_j, jl, Smax)
            tattn.ring_write(tc, tc.clone(), new_t, new_t, tl, Smax)
        else:
            jc, _ = jattn.cache_write(jc, jc, new_j, new_j, jl)
            tattn.cache_write(tc, tc.clone(), new_t, new_t, tl)
        _same_bytes(tc, jc)


def test_verify_window_and_paged_writes_match_jax_bytes():
    rng = np.random.default_rng(5)
    B, W, Smax, K, hd, ps = 2, 4, 12, 2, 8, 4
    jkv, tkv = _kv(rng, B, W, K, hd)
    lens = np.array([3, 10], np.int32)      # row 1 runs past the cache
    # transformer._layer_verify's scatter (out-of-range positions drop)
    jc = jnp.zeros((B, Smax, K, hd), JE4M3)
    pos = jnp.asarray(lens)[:, None] + jnp.arange(W)[None, :]
    jc = jc.at[jnp.arange(B)[:, None], pos].set(jkv.astype(JE4M3))
    tc = torch.zeros((B, Smax, K, hd), dtype=E4M3)
    ttfm.window_write(tc, tkv, torch.from_numpy(lens))
    _same_bytes(tc, jc)
    # paged.py's writes: pool.at[pg, off].set(k.astype(pool dtype))
    pg = np.array([[1, 1, 2, 2], [3, 3, 3, 0]])
    off = np.array([[2, 3, 0, 1], [1, 2, 3, 0]])
    jpool = jnp.zeros((5, ps, K, hd), JE4M3).at[pg, off].set(
        jkv.astype(JE4M3))
    tpool = torch.zeros((5, ps, K, hd), dtype=E4M3)
    tattn.store(tpool, (torch.from_numpy(pg), torch.from_numpy(off)), tkv)
    assert (tpool.view(torch.uint8)[1:].numpy() == _bits(jpool)[1:]).all()


# --- the slice as a whole ----------------------------------------------------


@pytest.fixture(scope="module")
def yi_bf16():
    """A bf16 reduced yi-9b in both packages, the port on JAX's params."""
    jcfg = dataclasses.replace(jreduce(jget_config("yi-9b")),
                               dtype="bfloat16")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(reduce_for_smoke(get_config("yi-9b")),
                               dtype="bfloat16")
    return jcfg, jm, jp, tcfg, build_model(tcfg), from_jax(_flatten(jp),
                                                           "cpu")


def test_prefill_and_decode_on_e4m3_match_jax(yi_bf16):
    jcfg, jm, jp, tcfg, tm, tp = yi_bf16
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 15)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    with jopt.flags(kv_cache_f8=True):
        js = jm.init_state(2, 32)
        prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)
        lg, js = prefill(jp, {"tokens": jnp.asarray(tokens[:, :12]),
                              "lengths": jnp.asarray(lens)}, js)
        want = [np.asarray(lg, np.float32)]
        for t in range(3):
            lg, js = decode(jp, jnp.asarray(tokens[:, 12 + t]), js)
            want.append(np.asarray(lg, np.float32))
    with opt.flags(kv_cache_f8=True):
        ts = tm.init_state(2, 32, device="cpu")
    lg, ts = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :12]),
                             "lengths": torch.from_numpy(lens)}, ts)
    got = [lg.float().numpy()]
    for t in range(3):
        lg, ts = tm.decode(tp, torch.from_numpy(tokens[:, 12 + t]), ts)
        got.append(lg.float().numpy())
    scale = max(float(np.abs(w).max()) for w in want) + 1.0
    for g, w in zip(got, want):
        assert np.abs(g - w).max() < 5e-2 * scale
    jflat, tflat = to_flat({"k": ts["cache"]["k"]}), js["cache"]["k"]
    assert jflat["k"].dtype == np.asarray(tflat).dtype
    for b, n in enumerate(lens + 3):          # valid positions only
        g = ts["cache"]["k"][:, b, :n].float().numpy()
        w = np.asarray(tflat[:, b, :n], np.float32)
        assert_allclose(g, w, rtol=0.125, atol=5e-2 * np.abs(w).max())
        assert (g == w).mean() > 0.9


@pytest.fixture(scope="module")
def f8_engines():
    """Dense, paged and speculative engines over one bf16 reduced yi, all
    built under kv_cache_f8 (the port's own params)."""
    tcfg = dataclasses.replace(reduce_for_smoke(get_config("yi-9b")),
                               dtype="bfloat16")
    model = build_model(tcfg)
    params = model.init(0, "cpu")
    kw = dict(max_len=32, max_batch=4)
    with opt.flags(kv_cache_f8=True):
        dense = InferenceEngine(model, params, **kw)
        paged = PagedInferenceEngine(model, params, page_size=16, **kw)
        spec = SpeculativeEngine(InferenceEngine(model, params, **kw),
                                 InferenceEngine(model, params, **kw),
                                 max_window=4)
    return dense, paged, spec


def _work(n=4, budget=8):
    return [([1 + i, 2 + (i % 3), 3, 4 + i], SamplingParams(
        max_new_tokens=budget,
        temperature=(0.0 if i % 3 == 0 else 0.8 + 0.1 * i),
        top_k=(8 if i % 3 == 1 else 0), seed=300 + i)) for i in range(n)]


def _streams(engine, work, num_slots=4):
    s = ContinuousBatchingScheduler(engine, num_slots=num_slots)
    reqs = [s.submit(p, sampling=sp) for p, sp in work]
    s.run()
    assert all(r.done for r in reqs)
    return s, [(r.output, r.finish_reason) for r in reqs]


def test_dense_paged_and_speculative_e4m3_streams_equal(f8_engines):
    dense, paged, spec = f8_engines
    sd, want = _streams(dense, _work())
    assert sd.state["cache"]["k"].dtype == E4M3
    sp, got = _streams(paged, _work())
    assert sp.state["cache"]["k"].dtype == E4M3
    assert got == want
    ss, spec_got = _streams(spec, _work())
    assert ss.state["target"]["cache"]["k"].dtype == E4M3
    assert spec_got == want
    assert ss.speculation_stats()["spec_ticks"] > 0
