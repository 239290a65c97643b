"""The port's continuous-batching scheduler and ``SchedulerService``
against the JAX package's, on the CPU.

Same weights (the shared conftest's JAX smoke params via
``params.from_jax``), same request schedules: token streams, finish
reasons, tick counts, prefill grouping and transfer accounting must be
identical to the JAX scheduler's, greedy and seeded, for the dense and
paged engines and for yi-9b and h2o-danube (sliding window; its dense
cache is a ring).  Then the scheduler contracts of tests/test_scheduler.py
and tests/test_device_sampling.py, and the service's entry points:
``submit_and_wait``, ``submit_request``, ``cancel``, ``pause``/``resume``,
``warm``, ``begin_retire``/``drain``, ``stats`` (the JAX key set),
``close`` and ``abandon``, deadlines, priorities, fair dequeue, the
duck-typed ``faults`` and ``ctx.trace`` hooks.
"""

import threading
import time

import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.core import ContinuousBatchingScheduler as JScheduler
from repro.core import InferenceEngine as JEngine
from repro.core import PagedInferenceEngine as JPaged
from repro.core import SamplingParams as JSamplingParams
from repro.core.scheduler import SchedulerService as JService
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (ContinuousBatchingScheduler, InferenceEngine,
                              PagedInferenceEngine, SamplingParams,
                              SchedulerBusy, SchedulerService)
from repro_torch.core import scheduler as tsched
from repro_torch.models import build_model
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


MAX_LEN = {"yi-9b": 64, "h2o-danube-1.8b": 96}


class Pair:
    """A JAX engine and the port's, same params, same geometry."""

    def __init__(self, arch, kind):
        _, jmodel, jp = smoke_model(arch)
        tmodel = build_model(reduce_for_smoke(get_config(arch)))
        tp = from_jax(_flatten(jp), "cpu")
        kw = dict(max_len=MAX_LEN[arch], max_batch=4)
        if kind == "paged":
            self.jax = JPaged(jmodel, jp, page_size=16, **kw)
            self.torch = PagedInferenceEngine(tmodel, tp, page_size=16, **kw)
        else:
            self.jax = JEngine(jmodel, jp, **kw)
            self.torch = InferenceEngine(tmodel, tp, **kw)
        self.vocab = jmodel.config.vocab_size


_PAIRS = {}


def pair(arch, kind) -> Pair:
    """Engines are cached per module: the JAX side's jit caches live on
    them, so compiles are shared across the tests."""
    if (arch, kind) not in _PAIRS:
        _PAIRS[arch, kind] = Pair(arch, kind)
    return _PAIRS[arch, kind]


SPECS = {
    "greedy": [dict(max_new_tokens=n) for n in (6, 9, 4, 12, 7)],
    "mixed": [dict(max_new_tokens=8),
              dict(max_new_tokens=10, temperature=0.8, top_k=50, top_p=0.9,
                   seed=7),
              dict(max_new_tokens=6, temperature=1.0, seed=3),
              dict(max_new_tokens=9, temperature=0.7, top_p=0.8, seed=11),
              dict(max_new_tokens=5, temperature=1.2, top_k=8, seed=19)],
}


def _prompts(vocab, seed=0, lengths=(5, 17, 3, 40, 9)):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, (n,)).tolist() for n in lengths]


def _drive(sched, prompts, specs, samp_cls):
    reqs = [sched.submit(p, sampling=samp_cls(**sp))
            for p, sp in zip(prompts, specs)]
    sched.run()
    return {"streams": [(r.output, r.finish_reason) for r in reqs],
            "steps": sched.steps, "ticks": sched.decode_ticks,
            "prefill_forwards": sched.prefill_forwards,
            "prefill_requests": sched.prefill_requests,
            "transfer": sched.decode_transfer_bytes,
            "prefill_tokens": sched.prefill_tokens_total,
            "pager": sched.pager_stats()}


def _both(p: Pair, prompts, specs, **kw):
    want = _drive(JScheduler(p.jax, **kw), prompts, specs, JSamplingParams)
    got = _drive(ContinuousBatchingScheduler(p.torch, **kw), prompts, specs,
                 SamplingParams)
    return got, want


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("arch", ["yi-9b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("workload", ["greedy", "mixed"])
def test_streams_match_jax_scheduler(kind, arch, workload):
    """Five requests on two slots (slots reused, three sequence buckets):
    every stream, reason and counter equals the JAX scheduler's."""
    p = pair(arch, kind)
    got, want = _both(p, _prompts(p.vocab), SPECS[workload], num_slots=2)
    assert got == want
    assert all(r == "length" for _, r in got["streams"])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_host_sampling_path_matches_jax(kind):
    """``device_sampling=False``: the numpy TokenSampler reference path,
    with full logits crossing to the host when any slot samples."""
    p = pair("yi-9b", kind)
    got, want = _both(p, _prompts(p.vocab, 1), SPECS["mixed"], num_slots=3,
                      device_sampling=False)
    assert got == want
    assert got["transfer"] > 3 * 4 * got["ticks"]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_stop_and_eos_reasons_match_jax(kind):
    p = pair("yi-9b", kind)
    prompts = _prompts(p.vocab, 2, (6, 11, 4))
    first = _both(p, prompts, [dict(max_new_tokens=12)] * 3,
                  num_slots=3)[1]["streams"]
    eos, stop = first[0][0][3], first[1][0][5]
    specs = [dict(max_new_tokens=12, eos_id=eos),
             dict(max_new_tokens=12, stop=(stop,)),
             dict(max_new_tokens=12, eos_id=eos, stop=(stop,))]
    got, want = _both(p, prompts, specs, num_slots=3)
    assert got == want
    reasons = [r for _, r in got["streams"]]
    assert reasons[0] == "eos" and reasons[1] == "stop"


# --- tests/test_scheduler.py's contracts ---------------------------------------


def test_scheduler_matches_direct_generation():
    """Tokens under continuous batching equal a dedicated single-request
    ``engine.generate`` (slot isolation)."""
    eng = pair("h2o-danube-1.8b", "dense").torch
    sched = ContinuousBatchingScheduler(eng, num_slots=2)
    prompts = [[1, 2, 3], [7, 8, 9, 10], [20, 21], [5, 4, 3, 2, 1]]
    reqs = [sched.submit(p, max_new_tokens=5) for p in prompts]
    sched.run()
    for req, prompt in zip(reqs, prompts):
        assert req.output == eng.generate([prompt],
                                          max_new_tokens=5).tokens[0]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_slots_are_reused(kind):
    sched = ContinuousBatchingScheduler(pair("yi-9b", kind).torch,
                                        num_slots=2)
    for i in range(6):
        sched.submit([1 + i, 2, 3], max_new_tokens=3)
    done = sched.run()
    assert len(done) == 6
    assert sched.active == 0 and sched.pending == 0
    assert sched.steps <= 6 * 3


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_more_requests_than_slots_all_finish(kind):
    sched = ContinuousBatchingScheduler(pair("yi-9b", kind).torch,
                                        num_slots=3)
    reqs = [sched.submit([i + 1], max_new_tokens=2 + i % 3)
            for i in range(10)]
    sched.run()
    assert all(r.done for r in reqs)
    assert all(len(r.output) == 2 + i % 3 for i, r in enumerate(reqs))


# --- tests/test_device_sampling.py's scheduler contracts ----------------------


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_seeded_streams_bytematch_across_runs(kind):
    eng = pair("yi-9b", kind).torch
    configs = [SamplingParams(temperature=0.9, seed=7, max_new_tokens=6),
               SamplingParams(temperature=0.0, max_new_tokens=5),
               SamplingParams(temperature=1.2, top_k=8, seed=3,
                              max_new_tokens=7),
               SamplingParams(temperature=0.7, top_p=0.8, seed=19,
                              max_new_tokens=6)]
    prompts = [[1, 2, 3], [9, 8, 7], [4, 4], [5, 1, 2, 6]]

    def run_once():
        sched = ContinuousBatchingScheduler(eng, num_slots=2)
        reqs = [sched.submit(p, sampling=s)
                for p, s in zip(prompts, configs)]
        sched.run()
        return [r.output for r in reqs]

    assert run_once() == run_once()


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_decode_tick_transfer_is_token_ids_only(kind):
    eng = pair("yi-9b", kind).torch
    num_slots = 2
    sched = ContinuousBatchingScheduler(eng, num_slots=num_slots)
    sched.submit([1, 2, 3], sampling=SamplingParams(temperature=0.9, seed=5,
                                                    max_new_tokens=8))
    sched.submit([7, 8], sampling=SamplingParams(temperature=0.0,
                                                 max_new_tokens=8))
    sched.run()
    assert sched.decode_ticks > 0
    per_tick = num_slots * np.dtype(np.int32).itemsize
    assert sched.tick_transfer_window == [per_tick] * sched.decode_ticks
    assert sched.decode_transfer_bytes == per_tick * sched.decode_ticks
    assert eng.decode_cache_size() is None      # eager: nothing compiled
    ref = ContinuousBatchingScheduler(eng, num_slots=num_slots,
                                      device_sampling=False)
    ref.submit([1, 2, 3], sampling=SamplingParams(temperature=0.9, seed=5,
                                                  max_new_tokens=8))
    ref.run()
    assert max(ref.tick_transfer_window) > per_tick


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_batched_prefill_admits_group_in_one_forward(kind):
    eng = pair("yi-9b", kind).torch
    sched = ContinuousBatchingScheduler(eng, num_slots=4)
    for i in range(3):                       # same seq bucket (len 3 -> 16)
        sched.submit([1 + i, 2, 3], max_new_tokens=3)
    calls_before = eng.prefill_calls
    sched.step()
    assert eng.prefill_calls - calls_before == 1
    assert sched.prefill_forwards == 1 and sched.prefill_requests == 3
    assert sched.active == 3
    done = sched.run()
    assert len(done) == 3 and all(len(r.output) == 3 for r in done)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_batched_prefill_groups_by_sequence_bucket(kind):
    eng = pair("yi-9b", kind).torch
    sched = ContinuousBatchingScheduler(eng, num_slots=4)
    sched.submit([1, 2, 3], max_new_tokens=3)                 # bucket 16
    sched.submit(list(range(1, 20)), max_new_tokens=3)        # bucket 32
    calls_before = eng.prefill_calls
    sched.step()
    assert eng.prefill_calls - calls_before == 2
    assert sched.active == 2
    sched.run()


# --- request plane: ctx, deadlines, priorities, fairness, traces -------------


class Ctx:
    """A stand-in for the serving layer's RequestContext (duck-typed)."""

    def __init__(self, priority=None, client=None, deadline=None,
                 trace=None):
        self.priority, self.client = priority, client
        self.deadline, self.trace = deadline, trace

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline


class Trace:
    """Records what the scheduler reports to ``ctx.trace``."""

    def __init__(self, trace_id):
        self.trace_id = trace_id
        self.events, self.spans, self.counters = [], [], {}

    def event(self, name, **kw):
        self.events.append(name)

    def span(self, name, t0, t1, **kw):
        self.spans.append(name)

    def bump(self, key, by=1):
        self.counters[key] = self.counters.get(key, 0) + by


def _admission_order(sched_cls, eng, samp_cls, ctxs, **kw):
    """Which request each single-slot admission picks, in order."""
    s = sched_cls(eng, num_slots=1, **kw)
    reqs = [s.submit([1 + i, 2], sampling=samp_cls(max_new_tokens=1),
                     ctx=c) for i, c in enumerate(ctxs)]
    order = []
    for _ in range(len(reqs)):
        before = {r.req_id for r in reqs if r.done}
        s.step()
        order += [r.req_id for r in reqs if r.done
                  and r.req_id not in before]
    return order, [r.finish_reason for r in reqs]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_priorities_fairness_and_deadlines_match_jax(kind):
    p = pair("yi-9b", kind)
    past = time.perf_counter() - 1.0
    ctxs = ([Ctx("bulk", "a")] * 3 + [Ctx(None, "b")] * 2
            + [Ctx(None, "a", deadline=past)] + [Ctx(None, "a")] * 3
            + [Ctx("bulk", "b")] * 2)
    weights = {"a": 3.0, "b": 1.0}
    want = _admission_order(JScheduler, p.jax, JSamplingParams, ctxs,
                            client_weights=weights, interactive_weight=2)
    got = _admission_order(ContinuousBatchingScheduler, p.torch,
                           SamplingParams, ctxs, client_weights=weights,
                           interactive_weight=2)
    assert got == want
    assert got[1][5] == "deadline"


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_trace_hooks_match_jax(kind):
    """The same workload reports the same events, spans and counter keys
    to ``ctx.trace`` on both schedulers (a pause/resume included)."""
    p = pair("yi-9b", kind)
    out = []
    for sched_cls, samp_cls, eng in ((JScheduler, JSamplingParams, p.jax),
                                     (ContinuousBatchingScheduler,
                                      SamplingParams, p.torch)):
        s = sched_cls(eng, num_slots=2)
        traces = [Trace(f"t{i}") for i in range(3)]
        reqs = [s.submit([3 + i] * (5 + i), ctx=Ctx(trace=t),
                         sampling=samp_cls(max_new_tokens=6, seed=i,
                                           temperature=0.5 * i))
                for i, t in enumerate(traces)]
        s.step()
        s.step()
        s.pause(reqs[0])
        s.step()
        s.resume(reqs[0])
        s.run()
        out.append([(t.events, t.spans, sorted(t.counters),
                     t.counters["decode_tokens"], t.counters["decode_ticks"],
                     t.counters["prefill_tokens"]) for t in traces])
    assert out[1] == out[0]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_cancel_queued_parked_and_active(kind):
    eng = pair("yi-9b", kind).torch
    s = ContinuousBatchingScheduler(eng, num_slots=1)
    a = s.submit([1, 2, 3], max_new_tokens=20)
    b = s.submit([4, 5], max_new_tokens=20)
    s.step()
    assert s.cancel(b) and b.finish_reason == "cancelled"     # queued
    s.pause(a)
    s.step()
    assert s.parked == [a]
    assert s.cancel(a) and a.finish_reason == "cancelled"     # parked
    c = s.submit([6], max_new_tokens=20)
    s.step()
    assert s.cancel(c) and not c.done                         # active
    s.step()
    assert c.finish_reason == "cancelled" and s.idle()
    assert s.cancelled_total == 3 and not s.cancel(c)
    if kind == "paged":
        assert s.pager.allocator.used_pages == len(s.pager.prefix)


def test_max_pending_sheds():
    eng = pair("yi-9b", "dense").torch
    s = ContinuousBatchingScheduler(eng, num_slots=1, max_pending=2)
    s.submit([1])
    s.submit([2])
    with pytest.raises(SchedulerBusy):
        s.submit([3])
    assert s.pending_high_water == 2


# --- SchedulerService ----------------------------------------------------------


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) and k not in (
        "k_hist",) else None for k, v in d.items()}


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_service_results_and_stats_keys_match_jax(kind):
    """``submit_and_wait`` returns the JAX service's result, and
    ``stats()`` has the JAX key set (pager and speculation sections
    included) with equal counters."""
    p = pair("yi-9b", kind)
    prompts = _prompts(p.vocab, 3, (4, 21, 9))
    samp = dict(max_new_tokens=7, temperature=0.9, top_k=40, seed=12)
    results, stats = [], []
    for svc_cls, samp_cls, eng in ((JService, JSamplingParams, p.jax),
                                   (SchedulerService, SamplingParams,
                                    p.torch)):
        svc = svc_cls(eng, num_slots=2)
        try:
            r = svc.submit_and_wait(prompts, sampling=samp_cls(**samp),
                                    timeout=120)
            results.append((r.tokens, r.finish_reasons, r.prompt_lengths))
            stats.append(svc.stats())
        finally:
            svc.close()
    assert results[1] == results[0]
    assert _key_tree(stats[1]) == _key_tree(stats[0])
    for key in ("ticks", "transfer_bytes_total", "prefill_forwards",
                "prefill_requests", "decode_tokens_total",
                "prefill_tokens_total"):
        assert stats[1]["decode"][key] == stats[0]["decode"][key], key
    assert stats[1]["pager"] == stats[0]["pager"]
    assert stats[1]["speculation"] == stats[0]["speculation"]
    assert stats[1]["completed"] == 3 and stats[1]["active_slots"] == 0


def test_service_streams_through_sinks_and_cancels():
    eng = pair("yi-9b", "paged").torch
    svc = SchedulerService(eng, num_slots=1)
    try:
        got, done = [], threading.Event()

        def sink(req, tok, finished):
            if tok is not None:
                got.append(tok)
            if finished:
                done.set()

        req = svc.submit_request([1, 2, 3], sampling=SamplingParams(
            max_new_tokens=6), sink=sink)
        assert done.wait(60)
        assert got == req.output and req.finish_reason == "length"
        want = svc.submit_and_wait([[1, 2, 3]], max_new_tokens=6)
        assert want.tokens[0] == got
        # a queued request cancelled before admission releases its waiter
        svc.pause(req)                       # a finished request: no-op
        hold = threading.Event()
        blocker = svc.submit_request([5], sampling=SamplingParams(
            max_new_tokens=60), sink=lambda r, t, f: hold.set() if f else 0)
        queued = svc.submit_request([6], sampling=SamplingParams(
            max_new_tokens=2), sink=lambda r, t, f: None)
        assert svc.cancel(queued) and queued.finish_reason == "cancelled"
        svc.cancel(blocker)
        assert hold.wait(60)
        assert blocker.finish_reason in ("cancelled", "length")
        with pytest.raises(ValueError):
            svc.submit_and_wait([[1] * 200])     # no sequence bucket
    finally:
        svc.close()


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_service_pause_resume_warm_retire_drain(kind):
    eng = pair("yi-9b", kind).torch
    svc = SchedulerService(eng, num_slots=2)
    try:
        secs = svc.warm(seq_lens=[16, 32])
        assert secs > 0
        ref = svc.submit_and_wait([[9, 8, 7]], sampling=SamplingParams(
            max_new_tokens=12, temperature=0.9, seed=42)).tokens[0]
        done = threading.Event()
        req = svc.submit_request([9, 8, 7], sampling=SamplingParams(
            max_new_tokens=12, temperature=0.9, seed=42),
            sink=lambda r, t, f: done.set() if f else None)
        svc.pause(req)
        deadline = time.monotonic() + 30
        while not svc.scheduler.parked and not req.done:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        svc.resume(req)
        assert done.wait(60) and req.output == ref
        svc.begin_retire()
        assert svc.retiring
        with pytest.raises(RuntimeError):
            svc.submit_and_wait([[1]])
        assert svc.drain(timeout=30)
        st = svc.stats(lock_timeout=5.0)
        assert st["completed"] >= 2
        if kind == "paged" and st["pauses"]:
            assert st["pager"]["resumes_without_recompute"] == st["pauses"]
    finally:
        svc.close()
    assert not svc.alive


class Faults:
    """A duck-typed fault hook that raises once at one site."""

    def __init__(self, site, at=0):
        self.site, self.at, self.fired = site, at, 0

    def fire(self, site, **info):
        if site == self.site:
            self.fired += 1
            if self.fired == self.at + 1:
                raise RuntimeError(f"injected {site}")


@pytest.mark.parametrize("site", ["engine_step", "prefill", "decode_tick"])
def test_service_survives_a_faulted_tick(site):
    """A fault fails the requests in flight with the error, and the driver
    keeps serving the next ones."""
    eng = pair("yi-9b", "paged").torch
    faults = Faults(site, at=1 if site == "engine_step" else 0)
    svc = SchedulerService(eng, num_slots=2, faults=faults)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            svc.submit_and_wait([[1, 2, 3]], max_new_tokens=4, timeout=60)
        assert svc.driver_errors == 1
        # every page went back, a faulted prefill group's included
        assert svc.scheduler.pager.allocator.used_pages == len(
            svc.scheduler.pager.prefix)
        assert not svc.scheduler._admitting
        r = svc.submit_and_wait([[1, 2, 3]], max_new_tokens=4, timeout=60)
        assert r.finish_reasons == ["length"] and svc.consecutive_errors == 0
    finally:
        svc.close()


def test_service_close_fails_in_flight_and_abandon():
    eng = pair("yi-9b", "dense").torch
    svc = SchedulerService(eng, num_slots=1)
    errors = []
    svc.submit_request([1], sampling=SamplingParams(max_new_tokens=500),
                       sink=lambda r, t, f: errors.append(r.error)
                       if f else None)
    svc.close()
    assert errors and isinstance(errors[0], RuntimeError)
    with pytest.raises(RuntimeError):
        svc.submit_and_wait([[1]])
    other = SchedulerService(eng, num_slots=1)
    other.abandon()
    with pytest.raises(RuntimeError):
        other.submit_and_wait([[1]])
    other._thread.join(5.0)
    assert not other.alive


def test_uploader_copies_are_private():
    """On the CPU an upload is a private copy: later edits of the host
    mirror do not reach a tensor already handed to the engine."""
    up = tsched._Uploader(pair("yi-9b", "dense").torch.device)
    mirror = np.arange(4, dtype=np.int32)
    t = up("x", mirror)
    mirror[0] = 99
    assert t.tolist() == [0, 1, 2, 3]


def test_service_under_concurrent_callers():
    """More caller threads than cores, a short switch interval: every
    caller gets its own prompt's stream (the solo result), and the
    service's counters add up."""
    import sys
    eng = pair("yi-9b", "paged").torch
    prompts = [[1 + i, 2 + i % 5, 3] for i in range(24)]
    solo = ContinuousBatchingScheduler(eng, num_slots=4)
    reqs = [solo.submit(p, max_new_tokens=5) for p in prompts]
    solo.run()
    want = [r.output for r in reqs]
    svc = SchedulerService(eng, num_slots=4)
    got = [None] * len(prompts)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def call(i):
            got[i] = svc.submit_and_wait([prompts[i]], max_new_tokens=5,
                                         timeout=120).tokens[0]

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        st = svc.stats()
        svc.close()
    assert got == want
    assert st["completed"] == len(prompts) and st["active_slots"] == 0
    assert st["pager"]["pages_used"] == st["pager"]["prefix_cached_pages"]


# --- no caller waits for a tick in flight ----------------------------------------


class SlowTicks:
    """An engine over the pair's weights whose decode tick takes an extra
    ``delay`` seconds; ``in_tick`` is set while a tick runs and ``done``
    counts finished ticks."""

    def __init__(self, delay=0.5):
        base = pair("yi-9b", "dense").torch
        self.engine = InferenceEngine(base.model, base.params,
                                      max_len=base.max_len, max_batch=4)
        self.in_tick = threading.Event()
        self.done = 0
        real = self.engine.decode_sample

        def slow(*a, **kw):
            self.in_tick.set()
            time.sleep(delay)
            out = real(*a, **kw)
            self.in_tick.clear()
            self.done += 1
            return out

        self.engine.decode_sample = slow


@pytest.mark.parametrize("call", ["submit_request", "begin_retire", "cancel",
                                  "stats"])
def test_service_calls_do_not_wait_for_a_tick(call):
    """With a 0.5 s tick in flight, ``submit_request``, ``begin_retire``,
    ``cancel`` (of a queued request, which finishes at once) and ``stats``
    each return within 0.1 s, and no tick ends meanwhile; the streams are
    the plain scheduler's."""
    slow = SlowTicks()
    samp = SamplingParams(max_new_tokens=4)
    plain = ContinuousBatchingScheduler(pair("yi-9b", "dense").torch,
                                        num_slots=1)
    refs = [plain.submit(p, sampling=samp) for p in ([1, 2, 3], [4, 5])]
    plain.run()
    svc = SchedulerService(slow.engine, num_slots=1)
    try:
        sink = lambda r, t, f: None                          # noqa: E731
        a = svc.submit_request([1, 2, 3], sampling=samp, sink=sink)
        queued = (svc.submit_request([4, 5], sampling=samp, sink=sink)
                  if call == "cancel" else None)
        assert slow.in_tick.wait(30)
        ticks = slow.done
        t0 = time.perf_counter()
        if call == "submit_request":
            b = svc.submit_request([4, 5], sampling=samp, sink=sink)
        elif call == "begin_retire":
            svc.begin_retire()
        elif call == "cancel":
            assert svc.cancel(queued)
        else:
            st = svc.stats()
        elapsed = time.perf_counter() - t0
        assert slow.done == ticks and slow.in_tick.is_set()
        assert elapsed < 0.1, (call, elapsed)
        if call == "begin_retire":
            with pytest.raises(RuntimeError):
                svc.submit_request([6], sampling=samp, sink=sink)
            assert svc.drain(timeout=60)
        elif call == "cancel":
            assert queued.finish_reason == "cancelled" and queued.done
        elif call == "stats":
            assert st["num_slots"] == 1 and "speculation" in st
        deadline = time.monotonic() + 60
        while not a.done:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert a.output == refs[0].output
        if call == "submit_request":
            while not b.done:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert b.output == refs[1].output
    finally:
        svc.close()
    if call == "cancel":
        assert svc.stats()["cancelled"] == 1


def test_install_drain_carries_the_wait_like_jax():
    """An engine ``install`` while a 900-token stream decodes: the old
    service's ``begin_retire`` returns at once and the wait for the
    stream lands in ``drain_ms``, as in the JAX package (before, the
    port's ``begin_retire`` waited on the driver's lock and ``drain_ms``
    read ~0)."""
    from repro.core import InferenceEngine as JEng
    from repro.core.sampling import SamplingParams as JSamp
    from repro.serving import GenerationService as JGen
    from repro_torch.serving import GenerationService
    _, jmodel, jp = smoke_model("yi-9b")
    tmodel = build_model(reduce_for_smoke(get_config("yi-9b")))
    tp = from_jax(_flatten(jp), "cpu")
    out = {}
    for name, gen_cls, samp_cls, mk in (
            ("jax", JGen, JSamp,
             lambda: JEng(jmodel, jp, max_len=1024, max_batch=2)),
            ("torch", GenerationService, SamplingParams,
             lambda: InferenceEngine(tmodel, tp, max_len=1024,
                                     max_batch=2))):
        gen = gen_cls(mk(), num_slots=2)
        try:
            stream = gen.stream([1, 2, 3], samp_cls(max_new_tokens=900))
            it = stream.events()
            assert next(it)["event"] == "token"
            old = gen.entry_for().service
            real = old.begin_retire
            timing = {}

            def timed(_real=real, _t=timing):
                t0 = time.perf_counter()
                _real()
                _t["begin_retire_s"] = time.perf_counter() - t0

            old.begin_retire = timed
            t0 = time.perf_counter()
            res = gen.install("engine", 1, mk())
            install_s = time.perf_counter() - t0
            done = list(it)[-1]
            assert done["event"] == "done" and done["token_count"] == 900
            assert res["drained"]
            out[name] = (res["drain_ms"], 1e3 * install_s,
                         timing["begin_retire_s"])
        finally:
            gen.close()
    # both services wait in drain(), for most of a 900-token stream (the
    # JAX one's first ticks compile, so its begin_retire can wait too)
    for name, (drain_ms, install_ms, _) in out.items():
        assert drain_ms > 500, (name, out)
    drain_ms, install_ms, retire_s = out["torch"]
    assert drain_ms >= 0.8 * install_ms and retire_s < 0.1, out
