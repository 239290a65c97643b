"""The port's paged KV path (``models/paged.py``, ``PagedInferenceEngine``,
``MemoryLedger.add_kv_pages``) against the JAX package's, on the CPU, and
the five paged contracts of tests/test_paged.py re-run on the port.

Model level: the same weights (the shared conftest's JAX smoke params,
carried over with ``params.from_jax``) and the same numpy tokens, page
tables and lengths through ``paged_prefill`` (no context pages, and a
shared two-page context) and ``paged_decode_step`` of both packages.
Logits are compared at 1e-4 and the pool's valid positions at 2e-5.  The
port's C == 0 prefill runs K1's plain version where the JAX prefill takes
``gqa_attention``; the two differ only at padded query positions, so the
pool is compared at valid positions only (as tests/test_torch_decode.py
does for the dense cache).

Scheduler level: paged streams equal the port's dense streams for fresh
prompts, shared prefixes, pause/resume (reattached without recompute),
the max_len "length" finish and OOM recompute preemption.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from conftest import smoke_model
from repro.core import memory as jmemory
from repro.core.engine import page_kv_bytes as jpage_kv_bytes
from repro.models import paged as jpaged
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (ContinuousBatchingScheduler, InferenceEngine,
                              MemoryLedger, PagedInferenceEngine,
                              SamplingParams, page_kv_bytes)
from repro_torch.models import build_model
from repro_torch.models import paged as tpaged
from repro_torch.params import from_jax, state_from_jax


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

UNIT = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["yi-9b", "h2o-danube-1.8b"]
PS = 16


def _pair(arch):
    cfg, _, jp = smoke_model(arch)
    tcfg = reduce_for_smoke(get_config(arch))
    return cfg, jp, tcfg, from_jax(_flatten(jp), "cpu")


def _close(got, want, **tol):
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _pool(state):
    return {k: np.asarray(v, np.float32) for k, v in state["cache"].items()}


def test_init_paged_state_matches_jax():
    cfg, _, tcfg, _ = _pair("yi-9b")
    want = jpaged.init_paged_state(cfg, 3, 9, PS, 4)
    got = tpaged.init_paged_state(tcfg, 3, 9, PS, 4, device="cpu")
    for key in ("length", "page_table"):
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.int32
    for key in ("k", "v"):
        assert tuple(got["cache"][key].shape) == want["cache"][key].shape
        assert not got["cache"][key].any()
    assert tpaged.supports_paging(tcfg) == jpaged.supports_paging(cfg)


class Both:
    """One paged state driven through both packages in lockstep."""

    def __init__(self, arch, num_slots=2, num_pages=17, max_pages=4):
        self.cfg, self.jp, self.tcfg, self.tp = _pair(arch)
        self.jstate = jpaged.init_paged_state(self.cfg, num_slots,
                                              num_pages, PS, max_pages)
        self.tstate = state_from_jax(self.jstate, "cpu")

    def prefill(self, tokens, lengths, ctx_table, ctx_lens, dest):
        jl, self.jstate = jpaged.paged_prefill(
            self.jp, *map(jnp.asarray, (tokens, lengths)), self.jstate,
            *map(jnp.asarray, (ctx_table, ctx_lens, dest)), self.cfg,
            page_size=PS)
        tl, self.tstate = tpaged.paged_prefill(
            self.tp, *map(torch.from_numpy, (tokens, lengths)), self.tstate,
            *map(torch.from_numpy, (ctx_table, ctx_lens, dest)), self.tcfg,
            page_size=PS)
        return tl, jl

    def set_rows(self, table, lengths):
        self.jstate = {**self.jstate, "page_table": jnp.asarray(table),
                       "length": jnp.asarray(lengths)}
        self.tstate = {**self.tstate, "page_table": torch.from_numpy(table),
                       "length": torch.from_numpy(lengths)}

    def decode(self, token):
        jl, self.jstate = jpaged.paged_decode_step(
            self.jp, jnp.asarray(token), self.jstate, self.cfg, page_size=PS)
        tl, self.tstate = tpaged.paged_decode_step(
            self.tp, torch.from_numpy(token), self.tstate, self.tcfg,
            page_size=PS)
        return tl, jl


def _valid_pool_close(both, table, lengths):
    """The pool agrees at every row's valid positions, in every layer."""
    jpool, tpool = _pool(both.jstate), both.tstate["cache"]
    for key in ("k", "v"):
        for b, n in enumerate(lengths):
            pages = table[b, :-(-n // PS)]
            got = tpool[key][:, pages].reshape(
                tpool[key].shape[0], -1, *tpool[key].shape[3:])[:, :n]
            want = jpool[key][:, pages].reshape(
                got.shape[0], -1, *got.shape[2:])[:, :n]
            _close(got, want, **UNIT)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    """No context pages: ragged prefill into shuffled pages, then decode
    steps through the page table, a vacant row included."""
    both = Both(arch, num_slots=3)
    vocab = both.cfg.vocab_size
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, (3, 32)).astype(np.int32)
    lengths = np.array([32, 19, 5], np.int32)
    perm = (1 + rng.permutation(16)).astype(np.int32)
    dest = perm[:6].reshape(3, 2)
    logits, want = both.prefill(tokens, lengths, np.zeros((3, 0), np.int32),
                                np.zeros((3,), np.int32), dest)
    _close(logits, want, **LOGITS)
    table = np.zeros((3, 4), np.int32)
    table[:2, :2] = dest[:2]
    table[0, 2] = perm[6]                     # row 0 crosses into page 3
    _valid_pool_close(both, table, lengths[:2])
    both.set_rows(table, np.array([32, 19, 0], np.int32))  # row 2 vacant
    for step in range(4):
        token = rng.integers(0, vocab, (3,)).astype(np.int32)
        logits, want = both.decode(token)
        _close(logits[:2], np.asarray(want)[:2], **LOGITS)
        assert torch.isfinite(logits).all()
    _valid_pool_close(both, table, [36, 23])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_shared_context_matches_jax(arch):
    """C > 0: a two-page context prefilled once, then suffixes of two rows
    attending to it through ``_suffix_mask`` (danube's window of 16 cuts
    into the context)."""
    both = Both(arch)
    vocab = both.cfg.vocab_size
    rng = np.random.default_rng(1)
    ctx = rng.integers(0, vocab, (1, 32)).astype(np.int32)
    ctx_pages = np.array([[5, 9]], np.int32)
    both.prefill(np.repeat(ctx, 2, 0), np.array([32, 32], np.int32),
                 np.zeros((2, 0), np.int32), np.zeros((2,), np.int32),
                 np.repeat(ctx_pages, 2, 0))
    suffix = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    lengths = np.array([16, 7], np.int32)
    ctx_table = np.array([[5, 9], [5, 9]], np.int32)
    dest = np.array([[3], [12]], np.int32)
    logits, want = both.prefill(suffix, lengths, ctx_table,
                                np.array([32, 32], np.int32), dest)
    _close(logits, want, **LOGITS)
    table = np.array([[5, 9, 3, 0], [5, 9, 12, 0]], np.int32)
    _valid_pool_close(both, table, [48, 39])
    both.set_rows(table, np.array([48, 39], np.int32))
    logits, want = both.decode(np.array([7, 11], np.int32))
    _close(logits, want, **LOGITS)


@pytest.mark.parametrize("window", [None, 5])
def test_suffix_mask_matches_jax(window):
    ctx_lens = np.array([32, 0, 16], np.int32)
    suf_lens = np.array([3, 8, 1], np.int32)
    want = jpaged._suffix_mask(8, 32, jnp.asarray(ctx_lens),
                               jnp.asarray(suf_lens), window)
    got = tpaged._suffix_mask(8, 32, torch.from_numpy(ctx_lens),
                              torch.from_numpy(suf_lens), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- engine -------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    _, _, tcfg, tp = _pair("yi-9b")
    model = build_model(tcfg)
    dense = InferenceEngine(model, tp, max_len=64, max_batch=4)
    paged = PagedInferenceEngine(model, tp, max_len=64, max_batch=4,
                                 page_size=16)
    return dense, paged


def test_engine_sizing_matches_jax(engines):
    _, paged = engines
    cfg, _, tcfg, _ = _pair("yi-9b")
    assert paged.num_pages == 4 * (64 // 16) + 1
    assert paged.page_bytes == page_kv_bytes(tcfg, 16) == \
        jpage_kv_bytes(cfg, 16)
    assert [paged.ctx_bucket_for(n) for n in range(5)] == [0, 1, 2, 4, 4]
    model = paged.model
    by_budget = PagedInferenceEngine(model, paged.params, max_len=64,
                                     max_batch=4,
                                     hbm_budget_bytes=10 * paged.page_bytes)
    assert by_budget.num_pages == 10
    state = by_budget.new_state(2)
    assert state["cache"]["k"].shape[1] == 10
    assert state["page_table"].shape == (2, 4)
    with pytest.raises(ValueError, match="multiple"):
        PagedInferenceEngine(model, paged.params, max_len=60, page_size=16)
    with pytest.raises(ValueError, match="cannot hold"):
        PagedInferenceEngine(model, paged.params, max_len=64, num_pages=4)
    with pytest.raises(NotImplementedError):
        paged.generate([[1, 2]])


def test_memory_ledger_kv_pages_matches_jax(engines):
    _, paged = engines
    jl = jmemory.MemoryLedger(n_chips=1, hbm_per_chip=80 * 2**30)
    tl = MemoryLedger(n_chips=1, hbm_per_chip=80 * 2**30)
    for ledger in (jl, tl):
        ledger.add_kv_pages("pool", paged.page_bytes, paged.num_pages)
    assert tl.bytes_per_chip == jl.bytes_per_chip
    assert tl.remaining_per_chip() == jl.remaining_per_chip()
    assert tl.entries[0].kind == "kv_pages"


# --- tests/test_paged.py's contracts, on the port -----------------------------


def _mixed_workload(n=6, budget=8):
    return [([1 + i, 2 + (i % 3), 3], SamplingParams(
        max_new_tokens=budget,
        temperature=(0.0 if i % 3 == 0 else 0.8 + 0.1 * i),
        top_k=(8 if i % 3 == 1 else 0), seed=200 + i)) for i in range(n)]


def _run(engine, work, num_slots=4):
    s = ContinuousBatchingScheduler(engine, num_slots=num_slots)
    reqs = [s.submit(p, sampling=sp) for p, sp in work]
    s.run()
    assert all(r.done for r in reqs)
    return s, [(r.output, r.finish_reason) for r in reqs]


def test_paged_streams_byte_match_dense(engines):
    dense, paged = engines
    _, want = _run(dense, _mixed_workload())
    s, got = _run(paged, _mixed_workload())
    assert got == want
    assert s.pager.allocator.used_pages == s.pager_stats()[
        "prefix_cached_pages"]            # only the cache holds pages now


def test_shared_prefix_prefills_once(engines):
    dense, paged = engines
    prefix = [11 + (i % 7) for i in range(32)]     # 2 full shared pages
    work = [(prefix + [60 + i], SamplingParams(max_new_tokens=4,
                                               seed=300 + i,
                                               temperature=0.7))
            for i in range(3)]
    # one slot serializes admission, so every follower sees the cache
    s, got = _run(paged, work, num_slots=1)
    _, want = _run(dense, work, num_slots=1)
    assert got == want
    st = s.pager_stats()
    # first request prefills the prefix; every follower reuses both pages
    assert st["prefill_tokens_reused"] == 32 * 2
    assert st["prefix_hits"] == 4
    assert st["prefill_tokens_forwarded"] < sum(len(p) for p, _ in work)


def test_pause_resume_reattaches_pages(engines):
    dense, paged = engines

    def drive(engine):
        s = ContinuousBatchingScheduler(engine, num_slots=2)
        a = s.submit([5, 6, 7], sampling=SamplingParams(
            max_new_tokens=12, temperature=0.9, seed=42))
        b = s.submit([8, 9], sampling=SamplingParams(max_new_tokens=12))
        for _ in range(4):
            s.step()
        s.pause(a)
        for _ in range(3):
            s.step()
        assert s.resume(a)
        s.run()
        return s, [a.output, b.output]

    ps, paged_out = drive(paged)
    ds, dense_out = drive(dense)
    assert paged_out == dense_out
    # dense recompute-preemption re-prefills; the paged path must NOT
    assert ds.prefill_requests == 3 and ps.prefill_requests == 2
    assert ps.pager_stats()["resumes_without_recompute"] == 1


def test_max_len_finishes_with_length_reason(engines):
    dense, paged = engines
    work = [([9, 8, 7], SamplingParams(max_new_tokens=10_000,
                                       temperature=0.8, seed=5))]
    _, want = _run(dense, work, num_slots=1)
    _, got = _run(paged, work, num_slots=1)
    assert got == want
    (tokens, reason), = got
    assert reason == "length" and 3 + len(tokens) == paged.max_len


@pytest.mark.parametrize("which", ["dense", "paged"])
def test_resume_near_max_len_regrowth(engines, which):
    engine = engines[0 if which == "dense" else 1]
    s = ContinuousBatchingScheduler(engine, num_slots=1)
    req = s.submit([9, 8, 7], sampling=SamplingParams(
        max_new_tokens=10_000, temperature=0.8, seed=5))
    for _ in range(55):                        # 3 + 55 of 64 used
        s.step()
    s.pause(req)
    s.step()                                   # parks the slot
    assert s.resume(req)
    s.run()
    assert req.finish_reason == "length"
    assert 3 + len(req.output) == engine.max_len


def test_oom_forces_recompute_preempt(engines):
    dense, paged = engines
    tiny = PagedInferenceEngine(paged.model, paged.params, max_len=64,
                                max_batch=4, page_size=16,
                                num_pages=6)          # 5 usable
    work = _mixed_workload(n=4, budget=30)            # wants 3 pages each
    s, got = _run(tiny, work, num_slots=4)
    _, want = _run(dense, work, num_slots=4)
    assert got == want
    assert s.pager_stats()["preempt_recompute"] >= 1
    assert s.pager.allocator.used_pages == len(s.pager.prefix)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_streams_match_jax_paged_engine(arch):
    """The port's paged engine under the scheduler against the JAX paged
    engine on the same params: greedy and seeded streams, one shared
    prefix, identical tokens and finish reasons."""
    from repro.core import ContinuousBatchingScheduler as JScheduler
    from repro.core import PagedInferenceEngine as JPaged
    from repro.core import SamplingParams as JSamplingParams
    _, jmodel, jp = smoke_model(arch)
    tmodel = build_model(reduce_for_smoke(get_config(arch)))
    jeng = JPaged(jmodel, jp, max_len=64, max_batch=4, page_size=16)
    teng = PagedInferenceEngine(tmodel, from_jax(_flatten(jp), "cpu"),
                                max_len=64, max_batch=4, page_size=16)
    prefix = [3 + (i % 11) for i in range(32)]
    specs = [dict(max_new_tokens=10),
             dict(max_new_tokens=12, temperature=0.8, top_k=50, top_p=0.9,
                  seed=7),
             dict(max_new_tokens=9, temperature=1.0, seed=3)]
    prompts = [prefix + [40], [5, 6, 7, 8], prefix + [41, 42]]
    outs = []
    for sched_cls, samp_cls, eng in ((JScheduler, JSamplingParams, jeng),
                                     (ContinuousBatchingScheduler,
                                      SamplingParams, teng)):
        s = sched_cls(eng, num_slots=2)
        reqs = [s.submit(p, sampling=samp_cls(**sp))
                for p, sp in zip(prompts, specs)]
        s.run()
        outs.append(([(r.output, r.finish_reason) for r in reqs],
                     s.pager_stats()))
    assert outs[1] == outs[0]


def test_window_engine_override_pages(engines):
    """An engine-level window on a dense arch reaches the paged step."""
    _, paged = engines
    eng = PagedInferenceEngine(paged.model, paged.params, max_len=64,
                               max_batch=4, page_size=16, window=6)
    _, jmodel, jp = smoke_model("yi-9b")
    from repro.core import ContinuousBatchingScheduler as JScheduler
    from repro.core import PagedInferenceEngine as JPaged
    jeng = JPaged(jmodel, jp, max_len=64, max_batch=4, page_size=16,
                  window=6)
    got, want = [], []
    for s, out in ((ContinuousBatchingScheduler(eng, num_slots=2), got),
                   (JScheduler(jeng, num_slots=2), want)):
        reqs = [s.submit(p, max_new_tokens=10) for p in ([1, 2, 3] * 4,
                                                         [4, 5])]
        s.run()
        out.extend(r.output for r in reqs)
    assert got == want
