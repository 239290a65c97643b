"""Speculative decoding in the port against the JAX package's, on the CPU.

The contracts of tests/test_speculative.py, held by the port at reduced
fp32 yi-9b with the JAX params carried over (``params.from_jax``) and a
random 1-layer draft:

  * the verify window (dense ``verify_decode_step``, paged
    ``paged_verify_step``) equals the port's own sequential decode steps
    BITWISE, logits and committed cache, and JAX's verify at 1e-4; a window
    that runs past the cache's end (dense) or the page table (paged) raises
    nothing and clobbers no valid position or page;
  * ``speculative_accept`` gives JAX's draws and counts exactly;
  * ``SpeculativeEngine`` streams equal JAX's ``SpeculativeEngine`` streams
    and sequential decoding token for token, dense and paged;
  * the equal draft fully accepts, opted-out rows advance one token, and the
    scheduler's streams equal the plain scheduler's through park/resume and
    a deadline mid-window;
  * the adaptive-k controller's per-tick window and acceptance EMA follow
    the JAX scheduler's on the same traffic;
  * incompatible pairs are refused with JAX's messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.core import ContinuousBatchingScheduler as JScheduler
from repro.core import InferenceEngine as JEngine
from repro.core import PagedInferenceEngine as JPaged
from repro.core import SamplingParams as JSamplingParams
from repro.core.engine import SpeculativeEngine as JSpec
from repro.core.sampling import speculative_accept as jaccept
from repro.models import build_model as jbuild
from repro.models import paged as jpaged
from repro.models import transformer as jtransformer
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (ContinuousBatchingScheduler, InferenceEngine,
                              PagedInferenceEngine, SamplingParams,
                              SchedulerService, SpeculativeEngine, base_key)
from repro_torch.core import scheduler as tsched
from repro_torch.core.sampling import sampling_regime, speculative_accept
from repro_torch.models import build_model, paged, transformer
from repro_torch.params import from_jax


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

ARCH = "yi-9b"                      # dense GQA, no sliding window
MAX_LEN = 64
LOGITS = dict(rtol=1e-4, atol=1e-4)


class Models:
    """JAX and port models of the reduced target and a 1-layer draft, on
    the same params."""

    def __init__(self):
        cfg, self.jmodel, self.jp = smoke_model(ARCH)
        dcfg = dataclasses.replace(cfg, num_layers=1)
        self.jdmodel = jbuild(dcfg)
        self.jdp = self.jdmodel.init(jax.random.PRNGKey(7))
        tcfg = reduce_for_smoke(get_config(ARCH))
        self.cfg = tcfg
        self.model = build_model(tcfg)
        self.params = from_jax(_flatten(self.jp), "cpu")
        self.dmodel = build_model(dataclasses.replace(tcfg, num_layers=1))
        self.dparams = from_jax(_flatten(self.jdp), "cpu")
        self.vocab = tcfg.vocab_size

    def engines(self, kind, *, equal_draft=False):
        """(JAX target, JAX pair, port target, port pair)."""
        kw = dict(max_len=MAX_LEN, max_batch=4)
        jd = (self.jmodel, self.jp) if equal_draft else (self.jdmodel,
                                                         self.jdp)
        td = ((self.model, self.params) if equal_draft
              else (self.dmodel, self.dparams))
        if kind == "paged":
            jt = JPaged(self.jmodel, self.jp, page_size=16, **kw)
            jdr = JPaged(*jd, page_size=16, num_pages=jt.num_pages, **kw)
            tt = PagedInferenceEngine(self.model, self.params, page_size=16,
                                      **kw)
            tdr = PagedInferenceEngine(*td, page_size=16,
                                       num_pages=tt.num_pages, **kw)
        else:
            jt, jdr = JEngine(self.jmodel, self.jp, **kw), JEngine(*jd, **kw)
            tt = InferenceEngine(self.model, self.params, **kw)
            tdr = InferenceEngine(*td, **kw)
        return (jt, JSpec(jt, jdr, max_window=4), tt,
                SpeculativeEngine(tt, tdr, max_window=4))


_CACHE = {}


def models() -> Models:
    if "m" not in _CACHE:
        _CACHE["m"] = Models()
    return _CACHE["m"]


def engines(kind, equal_draft=False):
    key = (kind, equal_draft)
    if key not in _CACHE:
        _CACHE[key] = models().engines(kind, equal_draft=equal_draft)
    return _CACHE[key]


# --- the bitwise bar: verify window == sequential decode ----------------------


def _rand_cache(shape, seed):
    return np.random.default_rng(seed).normal(0, 0.3, shape).astype(
        np.float32)


def _dense_states(m, lengths, seed):
    B = len(lengths)
    ck = _rand_cache((m.cfg.num_layers, B, MAX_LEN, m.cfg.num_kv_heads,
                      m.cfg.head_dim), seed)
    cv = _rand_cache(ck.shape, seed + 1)
    ln = np.asarray(lengths, np.int32)

    def tstate():
        return {"cache": {"k": torch.from_numpy(ck.copy()),
                          "v": torch.from_numpy(cv.copy())},
                "length": torch.from_numpy(ln.copy())}

    jstate = {"cache": {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
              "length": jnp.asarray(ln)}
    return tstate, jstate


def _tokens(m, B, W, seed):
    return np.random.default_rng(seed).integers(
        0, m.vocab, (B, W)).astype(np.int32)


@pytest.mark.parametrize("lengths", [(5, 9), (3, MAX_LEN - 2)],
                         ids=["inside", "past_smax"])
def test_dense_verify_window_bitwise_matches_sequential(lengths):
    """W sequential ``decode_step`` calls and one ``verify_decode_step``
    give the same logits and the same cache bit for bit (a window past the
    cache's end drops its writes there, as the sequential steps do), and
    JAX's verify gives the same logits at 1e-4."""
    m = models()
    B, W = 2, 4
    tstate, jstate = _dense_states(m, lengths, 0)
    toks = _tokens(m, B, W, 1)
    seq, outs = tstate(), []
    for i in range(W):
        lg, seq = transformer.decode_step(m.params, torch.from_numpy(
            toks[:, i]), seq, m.cfg)
        outs.append(lg)
    seq_logits = torch.stack(outs, dim=1)
    ver_logits, ver = transformer.verify_decode_step(
        m.params, torch.from_numpy(toks), tstate(), m.cfg)
    assert torch.equal(seq_logits, ver_logits)
    assert torch.equal(ver["length"], torch.tensor(lengths,
                                                   dtype=torch.int32))
    for k in ("k", "v"):
        assert torch.equal(seq["cache"][k], ver["cache"][k])
    jl, jst = jtransformer.verify_decode_step(m.jp, jnp.asarray(toks),
                                              jstate, m.jmodel.config)
    np.testing.assert_allclose(ver_logits.numpy(), np.asarray(jl), **LOGITS)
    for k in ("k", "v"):
        np.testing.assert_allclose(ver["cache"][k].numpy(),
                                   np.asarray(jst["cache"][k]), **LOGITS)


def _paged_states(m, lengths, table, seed, num_pages=8, ps=16):
    B = len(lengths)
    shape = (m.cfg.num_layers, num_pages, ps, m.cfg.num_kv_heads,
             m.cfg.head_dim)
    ck, cv = _rand_cache(shape, seed), _rand_cache(shape, seed + 1)
    ln = np.asarray(lengths, np.int32)
    tb = np.asarray(table, np.int32)

    def tstate():
        return {"cache": {"k": torch.from_numpy(ck.copy()),
                          "v": torch.from_numpy(cv.copy())},
                "length": torch.from_numpy(ln.copy()),
                "page_table": torch.from_numpy(tb.copy())}

    jstate = {"cache": {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
              "length": jnp.asarray(ln), "page_table": jnp.asarray(tb)}
    del B
    return tstate, jstate, (ck, cv)


def test_paged_verify_window_bitwise_matches_sequential():
    m = models()
    B, W, ps = 2, 4, 16
    tstate, jstate, _ = _paged_states(m, (5, 17), [[1, 2, 0, 0],
                                                   [3, 4, 5, 0]], 2)
    toks = _tokens(m, B, W, 3)
    seq, outs = tstate(), []
    for i in range(W):
        lg, seq = paged.paged_decode_step(m.params, torch.from_numpy(
            toks[:, i]), seq, m.cfg, page_size=ps)
        outs.append(lg)
    ver_logits, ver = paged.paged_verify_step(
        m.params, torch.from_numpy(toks), tstate(), m.cfg, page_size=ps)
    assert torch.equal(torch.stack(outs, dim=1), ver_logits)
    for k in ("k", "v"):
        assert torch.equal(seq["cache"][k], ver["cache"][k])
    jl, _ = jpaged.paged_verify_step(m.jp, jnp.asarray(toks), jstate,
                                     m.jmodel.config, page_size=ps)
    np.testing.assert_allclose(ver_logits.numpy(), np.asarray(jl), **LOGITS)


def test_paged_verify_window_past_the_table_clobbers_no_page():
    """Row 1 sits 2 tokens before its 4-page ceiling: the window's last two
    positions go to the dump page (0), every valid page keeps its values
    but the window's own in-table writes, and the logits equal JAX's."""
    m = models()
    B, W, ps = 2, 4, 16
    table = [[1, 2, 0, 0], [3, 4, 5, 6]]
    tstate, jstate, (ck, _) = _paged_states(m, (5, 62), table, 4)
    toks = _tokens(m, B, W, 5)
    ver_logits, ver = paged.paged_verify_step(
        m.params, torch.from_numpy(toks), tstate(), m.cfg, page_size=ps)
    got = ver["cache"]["k"].numpy()
    written = {(1, 5), (1, 6), (1, 7), (1, 8), (6, 14), (6, 15)}
    for pg in range(1, 8):
        for off in range(ps):
            if (pg, off) not in written:
                assert np.array_equal(got[:, pg, off], ck[:, pg, off]), \
                    (pg, off)
    jl, jst = jpaged.paged_verify_step(m.jp, jnp.asarray(toks), jstate,
                                       m.jmodel.config, page_size=ps)
    np.testing.assert_allclose(ver_logits.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_allclose(got[:, 1:], np.asarray(jst["cache"]["k"])[
        :, 1:], **LOGITS)


# --- accept/reject ---------------------------------------------------------------


def test_speculative_accept_greedy_counts_and_draws():
    rng = np.random.default_rng(4)
    B, W, V = 3, 4, 32
    logits = rng.normal(size=(B, W, V)).astype(np.float32)
    argmax = logits.argmax(-1)
    drafts = argmax[:, :W - 1].astype(np.int32)
    drafts[1, 1] = (drafts[1, 1] + 1) % V                  # reject at j=1
    drafts[2, 0] = (drafts[2, 0] + 1) % V                  # reject at j=0
    z = np.zeros((B,), np.float32)
    zi = np.zeros((B,), np.int32)
    keys = np.zeros((B, 2), np.uint32)
    jd, jc = jaccept(jnp.asarray(logits), jnp.asarray(drafts),
                     jnp.asarray(z), jnp.asarray(zi), jnp.ones((B,)),
                     jnp.asarray(keys), jnp.asarray(zi))
    draws, counts = speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(z), torch.from_numpy(zi), torch.ones((B,)),
        torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(zi),
        regime="greedy")
    assert np.array_equal(draws.numpy(), argmax)
    assert counts.tolist() == [W, 2, 1]
    assert np.array_equal(draws.numpy(), np.asarray(jd))
    assert np.array_equal(counts.numpy(), np.asarray(jc))


@pytest.mark.parametrize("seed", range(25))
def test_speculative_accept_sampled_matches_jax(seed):
    """Sampled draws and counts equal JAX's exactly, across the three
    regimes' rows (plain, top-k, top-p, greedy) and seeds; the drafts are
    the draws themselves with some positions broken, so counts vary."""
    rng = np.random.default_rng(100 + seed)
    B, W, V = 4, 4, 64
    logits = rng.normal(size=(B, W, V)).astype(np.float32) * 2.0
    temp = np.asarray([0.9, 1.3, 0.0, 0.7], np.float32)
    top_k = np.asarray([0, 8, 0, 0], np.int32)
    top_p = np.asarray([1.0, 1.0, 1.0, 0.85], np.float32)
    keys = np.stack([base_key(seed * 10 + i) for i in range(B)])
    ctr = rng.integers(0, 20, (B,)).astype(np.int32)
    jd0, _ = jaccept(jnp.asarray(logits), jnp.zeros((B, W - 1), jnp.int32),
                     jnp.asarray(temp), jnp.asarray(top_k),
                     jnp.asarray(top_p), jnp.asarray(keys), jnp.asarray(ctr))
    drafts = np.asarray(jd0)[:, :W - 1].copy()
    for b in range(B):
        j = rng.integers(0, W)              # W-1: no break, full accept
        if j < W - 1:
            drafts[b, j] = (drafts[b, j] + 1) % V
    jd, jc = jaccept(jnp.asarray(logits), jnp.asarray(drafts),
                     jnp.asarray(temp), jnp.asarray(top_k),
                     jnp.asarray(top_p), jnp.asarray(keys), jnp.asarray(ctr))
    draws, counts = speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p), torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(ctr), regime=sampling_regime(temp, top_k, top_p, V))
    assert np.array_equal(draws.numpy(), np.asarray(jd))
    assert np.array_equal(counts.numpy(), np.asarray(jc))


# --- engine level -----------------------------------------------------------------

MIXED = [dict(temperature=0.0),
         dict(temperature=0.9, seed=21),
         dict(temperature=1.2, top_k=8, seed=22),
         dict(temperature=0.7, top_p=0.8, seed=23)]
PROMPTS = [[1, 2, 3], [9, 8, 7], [4, 4], [5, 1, 2, 6]]


def _samp_arrays(specs):
    B = len(specs)
    temps = np.zeros((B,), np.float32)
    top_ks = np.zeros((B,), np.int32)
    top_ps = np.ones((B,), np.float32)
    keys = np.zeros((B, 2), np.uint32)
    for i, sp in enumerate(specs):
        p = SamplingParams(**sp)
        temps[i], top_ks[i], top_ps[i] = p.temperature, p.top_k, p.top_p
        keys[i] = base_key(p.resolve_seed())
    return temps, top_ks, top_ps, keys


def _jsamp(specs):
    t, k, p, key = _samp_arrays(specs)
    return {"temperature": jnp.asarray(t), "top_k": jnp.asarray(k),
            "top_p": jnp.asarray(p), "key": jnp.asarray(key)}


def _tsamp(specs, vocab):
    t, k, p, key = _samp_arrays(specs)
    return {"temperature": torch.from_numpy(t), "top_k": torch.from_numpy(k),
            "top_p": torch.from_numpy(p),
            "key": torch.from_numpy(key.astype(np.int64)),
            "regime": sampling_regime(t, k, p, vocab)}


def _batch(prompts, S=16):
    tokens = np.zeros((len(prompts), S), np.int32)
    lengths = np.ones((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        lengths[i] = len(p)
    return tokens, lengths


def _sequential(engine, prompts, samp, n):
    tokens, lengths = _batch(prompts)
    state = engine.new_state(len(prompts))
    logits, state = engine.prefill({"tokens": torch.from_numpy(tokens),
                                    "lengths": torch.from_numpy(lengths)},
                                   state)
    ctr = torch.zeros((len(prompts),), dtype=torch.int32)
    tok = engine.sample(logits, samp, ctr)
    out = [tok.numpy().copy()]
    ctr = ctr + 1
    for _ in range(n - 1):
        tok, state, ctr = engine.decode_sample(tok, state, samp, ctr)
        out.append(tok.numpy().copy())
    return np.stack(out, axis=1)


def _speculative(spec, prompts, samp, n, w=4, spec_on=None, jax_side=False):
    B = len(prompts)
    tokens, lengths = _batch(prompts)
    on = np.ones((B,), bool) if spec_on is None else np.asarray(spec_on)
    if jax_side:
        state = spec.new_state(B)
        logits, state = spec.prefill({"tokens": jnp.asarray(tokens),
                                      "lengths": jnp.asarray(lengths)},
                                     state)
        ctr = jnp.zeros((B,), jnp.int32)
        on = jnp.asarray(on)
    else:
        state = spec.new_state(B)
        logits, state = spec.prefill({"tokens": torch.from_numpy(tokens),
                                      "lengths": torch.from_numpy(lengths)},
                                     state)
        ctr = torch.zeros((B,), dtype=torch.int32)
        on = torch.from_numpy(on)
    tok = spec.sample(logits, samp, ctr)
    ctr = ctr + 1
    streams = [[int(t)] for t in np.asarray(tok)]
    all_counts = []
    while min(len(s) for s in streams) < n:
        draws, counts, tok, state, ctr = spec.speculative_step(
            w, tok, state, samp, ctr, on)
        draws, counts = np.asarray(draws), np.asarray(counts)
        all_counts.append(counts.copy())
        for b in range(B):
            streams[b].extend(int(t) for t in draws[b, :counts[b]])
    return np.stack([s[:n] for s in streams]), np.stack(all_counts)


def test_spec_engine_streams_equal_jax_and_sequential_dense():
    """A random (low-acceptance) draft and mixed per-row sampling: the
    port's speculative streams equal its sequential streams and JAX's
    speculative streams token for token, with JAX's accepted counts."""
    _, jspec, target, spec = engines("dense")
    samp = _tsamp(MIXED, models().vocab)
    want = _sequential(target, PROMPTS, samp, 12)
    got, counts = _speculative(spec, PROMPTS, samp, 12)
    jgot, jcounts = _speculative(jspec, PROMPTS, _jsamp(MIXED), 12,
                                 jax_side=True)
    assert np.array_equal(want, got)
    assert np.array_equal(jgot, got)
    assert np.array_equal(jcounts, counts)


def test_spec_engine_full_acceptance_with_equal_draft():
    """Greedy with a draft that IS the target: every window fully accepts
    (counts == W each tick) — the verify forward reproduces the draft's
    sequential decode bit for bit."""
    _, _, target, spec = engines("dense", equal_draft=True)
    samp = _tsamp([dict(temperature=0.0)] * 2, models().vocab)
    got, counts = _speculative(spec, [[1, 2, 3], [7, 8]], samp, 12)
    assert (counts == 4).all()
    assert np.array_equal(_sequential(target, [[1, 2, 3], [7, 8]], samp,
                                      12), got)


def test_spec_engine_opt_out_rows_advance_one():
    _, _, target, spec = engines("dense")
    samp = _tsamp(MIXED[:2], models().vocab)
    got, counts = _speculative(spec, PROMPTS[:2], samp, 8,
                               spec_on=[True, False])
    assert (counts[:, 1] == 1).all()
    assert np.array_equal(_sequential(target, PROMPTS[:2], samp, 8), got)


def test_spec_engine_pair_sizing_and_state_axes():
    """The paged pair shares one page table (page cost = both pools);
    ``state_batch_axes`` finds the batch axis of the nested state as JAX's
    does, and ``insert_rows`` moves rows of both caches."""
    jt, jspec, tt, tspec = engines("paged")
    assert tspec.paged and tspec.max_window == 4
    assert tspec.page_bytes == tt.page_bytes + tspec.draft.page_bytes
    assert tspec.page_bytes == jspec.page_bytes
    assert tspec.spec_levels == jspec.spec_levels == [1, 2, 4]
    assert tspec.draft_share == pytest.approx(jspec.draft_share)
    _, jd, _, td = engines("dense")
    assert td.state_batch_axes() == jd.state_batch_axes()
    pool, group = td.new_state(4), td.new_state(2)
    for tree in (group["target"]["cache"], group["draft"]["cache"]):
        for t in tree.values():
            t.fill_(1.0)
    out = td.insert_rows(pool, group, np.asarray([0, 1, 0, 0]),
                         np.asarray([False, True, False, False]))
    for half in ("target", "draft"):
        k = out[half]["cache"]["k"]
        assert k[:, 1].eq(1.0).all() and k[:, 0].eq(0.0).all()
    with pytest.raises(NotImplementedError):
        td.generate([[1, 2]])


def test_spec_engine_rejects_incompatible_pairs_like_jax():
    m = models()
    kw = dict(max_len=MAX_LEN, max_batch=4)
    cases = [
        (lambda: (JEngine(m.jmodel, m.jp, **kw),
                  JEngine(m.jdmodel, m.jdp, window=32, **kw)),
         lambda: (InferenceEngine(m.model, m.params, **kw),
                  InferenceEngine(m.dmodel, m.dparams, window=32, **kw)),
         "sliding window"),
        (lambda: (JEngine(m.jmodel, m.jp, **kw),
                  JEngine(m.jdmodel, m.jdp, max_len=32, max_batch=4)),
         lambda: (InferenceEngine(m.model, m.params, **kw),
                  InferenceEngine(m.dmodel, m.dparams, max_len=32,
                                  max_batch=4)),
         "max_len"),
        (lambda: (JPaged(m.jmodel, m.jp, page_size=16, **kw),
                  JEngine(m.jdmodel, m.jdp, **kw)),
         lambda: (PagedInferenceEngine(m.model, m.params, page_size=16,
                                       **kw),
                  InferenceEngine(m.dmodel, m.dparams, **kw)),
         "paged"),
        (lambda: (JEngine(m.jmodel, m.jp, **kw),
                  JEngine(m.jdmodel, m.jdp, **kw)),
         lambda: (InferenceEngine(m.model, m.params, **kw),
                  InferenceEngine(m.dmodel, m.dparams, **kw)),
         "max_window"),
    ]
    for jpair, tpair, match in cases:
        win = 1 if match == "max_window" else 4
        with pytest.raises(ValueError, match=match) as je:
            JSpec(*jpair(), max_window=win)
        with pytest.raises(ValueError, match=match) as te:
            SpeculativeEngine(*tpair(), max_window=win)
        assert str(te.value) == str(je.value)
    danube = reduce_for_smoke(get_config("h2o-danube-1.8b"))
    dm = build_model(danube)
    dp = dm.init(0, "cpu")
    with pytest.raises(ValueError, match="sliding window"):
        SpeculativeEngine(InferenceEngine(dm, dp, **kw),
                          InferenceEngine(m.dmodel, m.dparams, **kw))


# --- scheduler level ---------------------------------------------------------------


def _workload(n=6, budget=10):
    return [([1 + i, 2 + (i % 3), 3], dict(
        max_new_tokens=budget,
        temperature=(0.0 if i % 3 == 0 else 0.8 + 0.1 * i),
        top_k=(8 if i % 3 == 1 else 0), seed=400 + i)) for i in range(n)]


def _sched_run(cls, samp_cls, engine, work, num_slots=4, trajectory=False):
    s = cls(engine, num_slots=num_slots)
    reqs = [s.submit(p, sampling=samp_cls(**sp)) for p, sp in work]
    traj = []
    for _ in range(10_000):
        if s.idle():
            break
        s.step()
        if trajectory:
            st = s.speculation_stats()
            traj.append((st["window"], round(st["acceptance_ema"], 6),
                         st["spec_ticks"]))
    assert all(r.done for r in reqs)
    return s, [(r.output, r.finish_reason) for r in reqs], traj


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_scheduler_streams_equal_plain_and_jax(kind):
    """The speculative scheduler's streams equal the plain scheduler's and
    the JAX speculative scheduler's; its speculation stats equal JAX's; a
    paged run returns every page."""
    jt, jspec, tt, tspec = engines(kind)
    work = _workload()
    _, want, _ = _sched_run(ContinuousBatchingScheduler, SamplingParams,
                            tt, work)
    s, got, _ = _sched_run(ContinuousBatchingScheduler, SamplingParams,
                           tspec, work)
    js, jgot, _ = _sched_run(JScheduler, JSamplingParams, jspec, work)
    assert got == want
    assert got == jgot
    st, jst = s.speculation_stats(), js.speculation_stats()
    for key in ("enabled", "max_window", "window", "spec_ticks",
                "proposed_tokens", "accepted_tokens", "k_hist"):
        assert st[key] == jst[key], key
    assert st["acceptance_ema"] == pytest.approx(jst["acceptance_ema"])
    assert st["spec_ticks"] > 0 and st["proposed_tokens"] > 0
    assert s.decode_transfer_bytes == js.decode_transfer_bytes
    if kind == "paged":
        assert s.pager.allocator.used_pages == len(s.pager.prefix)


def test_spec_request_opt_out_field_respected():
    _, _, _, spec = engines("dense")
    work = [([1, 2, 3], dict(max_new_tokens=6, seed=31, temperature=0.8)),
            ([4, 5], dict(max_new_tokens=6, speculation=False))]
    s, _, _ = _sched_run(ContinuousBatchingScheduler, SamplingParams, spec,
                         work, num_slots=2)
    opted_out = [r for r in s.completed if not r.sampling.speculation]
    assert opted_out and all(r.spec_proposed == 0 for r in opted_out)
    assert any(r.spec_proposed > 0 for r in s.completed
               if r.sampling.speculation)


def test_spec_park_resume_and_deadline_mid_window():
    """Park/resume and a deadline eviction land between verify windows;
    streams equal the plain scheduler's and the JAX pair's, and the pager
    gets every page back."""
    jt, jspec, target, spec = engines("paged")

    def drive(cls, samp_cls, engine):
        s = cls(engine, num_slots=2)
        a = s.submit([5, 6, 7], sampling=samp_cls(
            max_new_tokens=14, temperature=0.9, seed=42))
        b = s.submit([8, 9], sampling=samp_cls(max_new_tokens=14))
        for _ in range(3):
            s.step()
        s.pause(a)
        for _ in range(2):
            s.step()
        assert s.resume(a)
        s.run()
        return s, [a.output, b.output]

    ps, spec_out = drive(ContinuousBatchingScheduler, SamplingParams, spec)
    _, plain_out = drive(ContinuousBatchingScheduler, SamplingParams, target)
    _, jax_out = drive(JScheduler, JSamplingParams, jspec)
    assert spec_out == plain_out == jax_out
    assert ps.pager.allocator.used_pages == len(ps.pager.prefix)

    class Ctx:
        priority = "interactive"

        def __init__(self):
            self.deadline = None

        def expired(self, now):
            return self.deadline is not None and now >= self.deadline

    s = ContinuousBatchingScheduler(spec, num_slots=2)
    ctx = Ctx()
    victim = s.submit([3, 1, 4], sampling=SamplingParams(
        max_new_tokens=40, temperature=0.9, seed=9), ctx=ctx)
    survivor = s.submit([2, 7], sampling=SamplingParams(max_new_tokens=8))
    for _ in range(2):
        s.step()
    ctx.deadline = 0.0                       # expires mid-stream
    s.run()
    assert victim.finish_reason == "deadline"
    assert survivor.done and len(survivor.output) == 8
    assert victim.pages is None
    assert s.pager.allocator.used_pages == len(s.pager.prefix)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_adaptive_backoff_trajectory_matches_jax(kind):
    """A draft that never agrees (random 1-layer model, sampled rows)
    drives acceptance to ~0: the controller backs off to level 1 with the
    JAX scheduler's per-tick window and acceptance EMA, and the streams
    still equal the plain scheduler's."""
    jt, jspec, tt, tspec = engines(kind)
    work = [([2 + i, 3, 4], dict(max_new_tokens=40, temperature=1.1,
                                 seed=500 + i)) for i in range(2)]
    s, got, traj = _sched_run(ContinuousBatchingScheduler, SamplingParams,
                              tspec, work, num_slots=2, trajectory=True)
    js, jgot, jtraj = _sched_run(JScheduler, JSamplingParams, jspec, work,
                                 num_slots=2, trajectory=True)
    _, want, _ = _sched_run(ContinuousBatchingScheduler, SamplingParams,
                            tt, work, num_slots=2)
    assert got == want == jgot
    assert traj == jtraj
    st = s.speculation_stats()
    assert st["k_hist"]["1"] > 0 and st["window"] == 1
    assert st["k_hist"] == js.speculation_stats()["k_hist"]


def test_spec_window_runs_past_max_len():
    """Requests whose prompts end near max_len: the last windows run past
    the dense cache's end and the paged table's ceiling; streams still
    equal the plain scheduler's, with reason "length"."""
    for kind in ("dense", "paged"):
        _, _, tt, tspec = engines(kind, equal_draft=True)
        work = [(list(range(1, MAX_LEN - 3)), dict(max_new_tokens=10)),
                (list(range(2, MAX_LEN - 6)), dict(max_new_tokens=10))]
        _, want, _ = _sched_run(ContinuousBatchingScheduler, SamplingParams,
                                tt, work, num_slots=2)
        s, got, _ = _sched_run(ContinuousBatchingScheduler, SamplingParams,
                               tspec, work, num_slots=2)
        assert got == want
        assert all(r == "length" for _, r in got)
        assert s.speculation_stats()["spec_ticks"] > 0


def test_spec_service_warm_runs_every_level_and_stats():
    """``SchedulerService.warm()`` on a pair runs one speculative step at
    every window level and a plain tick; mixed speculative and opted-out
    traffic afterwards streams as the plain engine does, and ``stats()``
    reports the speculation section."""
    _, _, target, spec = engines("dense")
    levels = []
    real = spec.speculative_step

    def recording(w, *a, **kw):
        levels.append(w)
        return real(w, *a, **kw)

    spec.speculative_step = recording
    svc = SchedulerService(spec, num_slots=2)
    try:
        svc.warm(seq_lens=[16], group_sizes=[1, 2])
        # the throwaway schedulers' ticks come first, then one step per
        # level on the throwaway state
        n = len(spec.spec_levels) - 1
        assert levels[-n:] == spec.spec_levels[1:]
        mixed = [dict(max_new_tokens=5, seed=9),
                 dict(max_new_tokens=5, temperature=0.8, top_k=8, seed=10,
                      speculation=False),
                 dict(max_new_tokens=4, temperature=1.1, top_p=0.9,
                      seed=11)]
        for sp in mixed:
            got = svc.submit_and_wait([[2, 7, 1]],
                                      sampling=SamplingParams(**sp))
            plain = ContinuousBatchingScheduler(target, num_slots=2)
            r = plain.submit([2, 7, 1], sampling=SamplingParams(**sp))
            plain.run()
            assert got.tokens == [r.output]
        st = svc.stats()
        assert st["speculation"]["enabled"] is True
        assert st["speculation"]["max_window"] == 4
        assert st["decode"]["compiled_steps"] is None
    finally:
        svc.close()
        del spec.speculative_step


def test_zero_schema_for_plain_engines():
    _, _, target, _ = engines("dense")
    s = ContinuousBatchingScheduler(target, num_slots=2)
    assert s.speculation_stats() is None
    assert set(tsched.ZERO_SPECULATION_STATS) == {
        "enabled", "max_window", "window", "acceptance_ema", "spec_ticks",
        "proposed_tokens", "accepted_tokens", "acceptance_rate", "k_hist",
        "draft_ms_total", "verify_ms_total", "draft_share_estimate"}
