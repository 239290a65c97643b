"""Continuous batching scheduler: the port of ``repro/core/scheduler.py``.

A fixed pool of ``num_slots`` decode slots shares one batched KV state
(the dense engine's per-slot cache, or the paged engine's page pool).
Requests are admitted into free slots as they arrive, decoded together one
token per tick, and evicted individually on EOS / stop token / token
budget / cancellation — so the decode batch composition changes every
tick.

The decode loop is DEVICE-RESIDENT.  Each request carries its OWN
sampling settings (``SamplingParams``), kept as per-slot parameter arrays
(temperature / top_k / top_p / base rng key) that ride into one decode-
and-sample call: the device computes the batched decode step AND every
slot's next token, and only the sampled ids — shape ``(num_slots,)`` int32
— cross to the host per tick, never the ``(num_slots, vocab)`` logits.
Token j of a seeded request is drawn with ``fold_in(PRNGKey(seed), j)``
(``repro_torch.core.rng``, bit-identical to ``jax.random``), a stateless
key that survives recompute-resume by construction, so the port's streams
equal the JAX scheduler's.  ``device_sampling=False`` keeps the numpy
``TokenSampler`` host path as the reference.

Admission is BATCHED: up to one pending request per free slot is popped
per tick, grouped by prefill signature (sequence bucket + extras signature;
sequence and context-page buckets on the paged engine), and each group runs
ONE bucketed prefill forward.  On the dense engine the group's rows land in
the pooled state through one gather-scatter (``engine.insert_rows``); on
the paged engine the prefill commits each row's K/V straight into its
pages, and shared full-page prompt prefixes are prefilled once
(``core/kv_pager.py``).

Request-plane integration: a request may carry a ``ctx`` (the serving
layer's ``RequestContext``) read duck-typed here — ``ctx.priority`` routes
it into one of two pending deques (interactive / bulk) drained with a
weighted round-robin, ``ctx.client`` into start-time fair dequeue within a
class, ``ctx.expired()`` is checked at every hand-off, and ``ctx.trace``
(duck-typed: ``event``/``span``/``bump``/``trace_id``) receives the
request's timeline.  ``max_pending`` bounds the pending deques
(``SchedulerBusy``).  A ``paused`` request is PREEMPTED: its slot is freed
while it parks; ``resume()`` re-admits it — by re-prefilling prompt +
output on the dense engine, by re-pointing its slot's page-table row at
its pinned pages (no recompute) on the paged one.  ``faults`` is a
duck-typed hook (``.fire(site, ...)``) fired at the ``decode_tick``,
``engine_step`` and ``prefill`` sites.

Differences of mechanism from the JAX module: the decode state is written
in place (the JAX engine donates it), so a state handed to the engine is
never reused except through the returned one; the host->device uploads of
the per-slot arrays, the page table and the prefill batches go through
pinned staging buffers with ``non_blocking`` copies (``_Uploader``), since
a copy from pageable memory waits for the device's queue to drain; and the
sampling regime is chosen on the host from the per-slot numpy mirrors.

Speculative decoding: over a ``SpeculativeEngine`` a tick runs the draft
scan, the verify forward and the accept step (``engine.speculative_step``)
at the window the adaptive-k controller picks, and the host receives the
(num_slots, w) draws and (num_slots,) accepted counts; a request's
``SamplingParams.speculation`` opts it out (its row advances one token).

``SchedulerService`` departs from the JAX service's driver on purpose: the
JAX step waits in XLA with the interpreter lock released, so callers get
the service lock between ticks, while the port's eager tick holds the
interpreter and would make every caller wait for it.  Here the driver
holds no lock across ``step()``: callers touch only the pending deques and
the parked list, under the scheduler's short ``lock`` (which the driver
takes only to pop, park and requeue), and ``stats()`` reads a snapshot the
driver publishes after each tick.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.engine import GenerationResult, InferenceEngine
from repro_torch.core.kv_pager import KVPager, PagerOOM, PrefixMatch
from repro_torch.core.sampling import (SamplingParams, TokenSampler, base_key,
                                       sampling_regime)
from repro_torch.core.telemetry import (BYTES_BUCKETS, Histogram, Reservoir,
                                        pctl)

# sink(request, token, done): token is None only for a terminal
# notification that produced no token (cancellation, driver error)
TokenSink = Callable[["Request", Optional[int], bool], None]


class SchedulerBusy(RuntimeError):
    """Pending deque at its bound; the serving layer sheds this as 429."""


@dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    extras: Optional[Dict[str, Any]] = None
    sampling: Optional[SamplingParams] = None
    sink: Optional[TokenSink] = None
    ctx: Optional[Any] = None           # serving RequestContext (duck-typed)
    output: List[int] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    paused: bool = False                # stalled consumer: preempt the slot
    pause_count: int = 0
    finish_reason: Optional[str] = None
    error: Optional[BaseException] = None
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    sampler: Optional[TokenSampler] = None
    base_key: Optional[np.ndarray] = None   # raw uint32[2] device rng key
    # ctx.trace cached at submit so hot paths pay one attribute load
    trace: Optional[Any] = None
    # snapshot of the scheduler's cumulative per-slot share accumulators,
    # taken at slot ATTACH; the delta against them at slot DETACH is the
    # request's decode accounting (see step()), O(1) per request
    share_mark: Optional[Tuple[int, float, float, float,
                               float, float]] = None
    # paged engines only: the KV pages this request owns references to.
    # Pages stay pinned while the request parks, so resume is O(1)
    # (re-point the slot's page-table row, no recompute).
    pages: Optional[List[int]] = None
    # speculative engines only: draft tokens proposed for / accepted by
    # this request (the stream's end-of-stream acceptance summary)
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def priority(self) -> str:
        return getattr(self.ctx, "priority", None) or "interactive"

    def expired(self, now: float) -> bool:
        return self.ctx is not None and self.ctx.expired(now)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


_WINDOW = 4096                  # bounded stat windows (trimmed to half)

# keys a pager stats() dict carries, zeroed for dense engines so the
# "pager" section of stats() has a stable schema either way
ZERO_PAGER_STATS: Dict[str, Any] = {
    "page_size": 0, "pages_total": 0, "pages_used": 0, "pages_free": 0,
    "pages_used_high_water": 0, "page_utilization": 0.0, "oom_events": 0,
    "prefix_cached_pages": 0, "prefix_hits": 0, "prefix_misses": 0,
    "prefix_hit_rate": 0.0, "prefix_hit_tokens": 0,
    "prefix_lookup_tokens": 0, "prefix_evictions": 0,
    "resumes_without_recompute": 0, "preempt_recompute": 0,
    "prefill_tokens_forwarded": 0, "prefill_tokens_reused": 0,
}

# speculation stats schema, zeroed for plain engines (a stable
# "speculation" section either way)
ZERO_SPECULATION_STATS: Dict[str, Any] = {
    "enabled": False, "max_window": 0, "window": 0,
    "acceptance_ema": 0.0, "spec_ticks": 0, "proposed_tokens": 0,
    "accepted_tokens": 0, "acceptance_rate": 0.0, "k_hist": {},
    "draft_ms_total": 0.0, "verify_ms_total": 0.0,
    "draft_share_estimate": 0.0,
}

# adaptive-k controller: acceptance EMA with hysteresis.  Below the low
# water mark the window halves (down to level 1 = plain ticks); above the
# high water mark it doubles back.  At level 1 a probe tick runs every
# SPEC_PROBE_INTERVAL ticks so a workload that turns acceptance-friendly
# again can climb out.
SPEC_EMA_ALPHA = 0.2
SPEC_LOW_WATER = 0.4
SPEC_HIGH_WATER = 0.8
SPEC_PROBE_INTERVAL = 64


class _Uploader:
    """Host -> device copies of the scheduler's small arrays (per-slot
    sampling params, token ids, counters, the page table and lengths, the
    prefill batches).

    On a CUDA device each array goes through a pinned staging buffer, one
    per (name, shape, dtype), with a ``non_blocking`` copy: a copy from
    pageable memory would wait for the device's queue to drain.  The
    buffer is reused only after the event recorded behind its last copy
    has completed, so a copy still in flight never reads a buffer being
    overwritten.  On the CPU the result is a private copy (the host
    mirrors keep changing)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._bufs: Dict[Tuple, Tuple[torch.Tensor, Any]] = {}

    def __call__(self, name: str, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if not self.pinned:
            return torch.from_numpy(arr.copy())
        key = (name, arr.shape, arr.dtype.str)
        buf, done = self._bufs.get(key, (None, None))
        if buf is None:
            buf = torch.empty(arr.shape, dtype=torch.from_numpy(arr).dtype,
                              pin_memory=True)
        else:
            done.synchronize()          # the last copy out of buf finished
        buf.numpy()[...] = arr
        out = buf.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._bufs[key] = (buf, done)
        return out


class ContinuousBatchingScheduler:
    def __init__(self, engine: InferenceEngine, num_slots: int = 4, *,
                 max_pending: Optional[int] = None,
                 interactive_weight: int = 4,
                 device_sampling: bool = True,
                 max_prefill_batch: Optional[int] = None,
                 client_weights: Optional[Dict[str, float]] = None,
                 faults: Optional[Any] = None):
        self.engine = engine
        self.num_slots = num_slots
        self.max_pending = max_pending
        # guards the pending deques and the parked list, the only state a
        # SchedulerService's caller threads touch while a tick runs; the
        # tick itself takes it only to pop, park and requeue
        self.lock = threading.RLock()
        # fault-injection hook (duck-typed ``.fire(site, **info)``); fired
        # at the decode_tick / engine_step / prefill sites
        self.faults = faults
        self.interactive_weight = max(1, interactive_weight)
        self.device_sampling = device_sampling
        # per-client weighted fair dequeue (start-time fair queueing):
        # each client tag advances a virtual clock by admitted-cost/weight
        # and the lowest clock is admitted next.  Tags absent from the map
        # weigh 1.0; untagged traffic shares one key.
        self.client_weights: Dict[str, float] = dict(client_weights or {})
        self._client_vt: Dict[Any, float] = {}
        # admissions per prefill forward: bounded by the engine's batch
        # buckets (and optionally tighter)
        cap = engine.batch_buckets.sizes[-1]
        self.max_prefill_batch = (min(cap, max_prefill_batch)
                                  if max_prefill_batch else cap)
        self._up = _Uploader(engine.device)
        self._vocab = engine.model.config.vocab_size
        self.state = engine.new_state(num_slots)
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.queue: Deque[Request] = collections.deque()       # interactive
        self.bulk_queue: Deque[Request] = collections.deque()
        self.parked: List[Request] = []      # paused (preempted) requests
        # popped for this tick's prefill groups and not yet landed: a
        # driver error fails them with the rest (see SchedulerService.
        # _fail_in_flight) instead of losing them and their pages
        self._admitting: List[Request] = []
        # retirement path: pausing is disabled while draining for an
        # engine swap, so every in-flight stream can actually finish
        self.preempt_enabled = True
        self._rr_credit = 0                  # weighted-dequeue state
        self._next_id = itertools.count()
        self._last_token = np.zeros((num_slots,), np.int32)
        # per-slot sampling params + token/counter mirrors (host side).
        # The device copies are re-uploaded only when a slot changes hands;
        # between admissions the token ids and counters stay DEVICE-
        # RESIDENT (the decode call returns next tick's inputs).
        self._temps = np.zeros((num_slots,), np.float32)
        self._top_ks = np.zeros((num_slots,), np.int32)
        self._top_ps = np.ones((num_slots,), np.float32)
        self._keys = np.zeros((num_slots, 2), np.int64)
        self._ctr = np.zeros((num_slots,), np.int32)  # == len(req.output)
        self._samp_dev: Optional[Dict[str, Any]] = None
        self._tok_dev: Optional[torch.Tensor] = None
        self._ctr_dev: Optional[torch.Tensor] = None
        # speculative engine pair: per-slot opt-out mask + the adaptive-k
        # controller (a level index into engine.spec_levels; level 0 is
        # the plain tick).  The streams do not depend on the controller:
        # emitted tokens are always the sequential draws.
        self.speculative = (bool(getattr(engine, "speculative", False))
                            and device_sampling)
        self._spec_on = np.zeros((num_slots,), bool)
        self._spec_dev: Optional[torch.Tensor] = None
        if self.speculative:
            self._spec_levels: List[int] = list(engine.spec_levels)
            self._spec_level = len(self._spec_levels) - 1
            self._accept_ema = 1.0
            self._spec_probe = SPEC_PROBE_INTERVAL
            self.spec_ticks = 0
            self.spec_proposed_total = 0
            self.spec_accepted_total = 0
            self.spec_draft_ms_total = 0.0
            self.spec_verify_ms_total = 0.0
            self.spec_k_hist: Dict[int, int] = {
                w: 0 for w in self._spec_levels}
        # paged engine: host-side page bookkeeping.  The device only ever
        # sees the (num_slots, max_pages) int32 page table + per-slot
        # lengths, re-uploaded (~KB) only when they change.
        self.paged = bool(getattr(engine, "paged", False))
        if self.paged:
            self.pager = KVPager(engine.num_pages, engine.page_size)
            self._table = np.zeros(
                (num_slots, engine.max_pages_per_seq), np.int32)
            self._lengths = np.zeros((num_slots,), np.int32)
            self._state_dirty = True
            self.resumes_fast = 0           # O(1) reattaches (no recompute)
            self.preempt_recompute = 0      # OOM-forced recompute preempts
            self.prefill_tokens_forwarded = 0
            self.prefill_tokens_reused = 0
        # recent finished requests (bounded — see _finish); completed_total
        # is the lifetime counter
        self.completed: List[Request] = []
        self.completed_total = 0
        self.steps = 0
        self.cancelled_total = 0
        self.deadline_total = 0
        self.pauses_total = 0
        self.pending_high_water = 0
        # decode-tick breakdown + transfer accounting: per tick, ONLY the
        # (num_slots,) token ids cross device->host on the sampling path
        self.decode_ticks = 0
        self.decode_transfer_bytes = 0       # lifetime, decode ticks only
        # cumulative per-slot SHARES: each decode tick adds that tick's
        # evenly-split cost exactly once (1 tick, device_ms/active,
        # host_ms/active, transfer/active); a request marks these at slot
        # attach and flushes the delta into its trace at detach
        self._share_ticks = 0
        self._share_device_ms = 0.0
        self._share_host_ms = 0.0
        self._share_transfer = 0.0
        self._share_draft_ms = 0.0       # speculative ticks only: the
        self._share_verify_ms = 0.0      # device-ms draft/verify split
        # lifetime cost totals the per-request attributions conserve
        # against: decode device/host ms and token counts
        self.decode_device_ms_total = 0.0
        self.decode_host_ms_total = 0.0
        self.decode_tokens_total = 0         # every generated token
        self.prefill_tokens_total = 0        # prompt tokens forwarded
        self.prefill_transfer_bytes = 0      # first-token path
        self.prefill_forwards = 0
        self.prefill_requests = 0            # admitted through them
        self.prefill_s_total = 0.0           # cumulative prefill seconds
        self.host_ms_window: List[float] = []
        self.device_ms_window: List[float] = []
        self.prefill_ms_window: List[float] = []
        self.tick_transfer_window: List[int] = []   # bytes per decode tick
        # request-level samples: fixed-size uniform reservoirs back the
        # percentiles; fixed-bucket histograms with slow-request exemplars
        # back a Prometheus exposition
        self.latency_res = Reservoir(2048)
        self.ttft_res = Reservoir(2048)
        self.itl_res = Reservoir(4096)       # inter-token gaps, seconds
        self.hist: Dict[str, Histogram] = {
            "request_latency_ms": Histogram(),
            "ttft_ms": Histogram(),
            "inter_token_ms": Histogram(),
            "queue_wait_ms": Histogram(),
            "prefill_ms": Histogram(),
            "decode_host_ms": Histogram(),
            "decode_device_ms": Histogram(),
            "tick_transfer_bytes": Histogram(BYTES_BUCKETS),
        }

    # --- client API ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               extras: Optional[Dict[str, Any]] = None,
               sampling: Optional[SamplingParams] = None,
               sink: Optional[TokenSink] = None,
               ctx: Optional[Any] = None,
               resume_output: Optional[Sequence[int]] = None,
               rng_key: Optional[np.ndarray] = None) -> Request:
        """Enqueue one prompt.  ``sampling`` (when given) carries the
        decode config — its max_new_tokens/eos_id override the positional
        knobs — and every request gets its own sampler.  ``ctx`` routes the
        request into its priority class's deque; a full pending deque
        raises SchedulerBusy.

        ``resume_output``/``rng_key`` is the failover resume path: the
        request starts with that output already emitted (admission
        prefills prompt+output with the sampling counter at len(output))
        and keeps the ORIGINAL base key, so the continuation draws the
        exact tokens the failed replica would have."""
        with self.lock:
            return self._submit(prompt, max_new_tokens, eos_id, extras,
                                sampling, sink, ctx, resume_output, rng_key)

    def _submit(self, prompt, max_new_tokens, eos_id, extras, sampling,
                sink, ctx, resume_output, rng_key) -> Request:
        if self.max_pending is not None and self.pending >= self.max_pending:
            raise SchedulerBusy(
                f"pending deque at its bound ({self.pending}"
                f"/{self.max_pending})")
        if sampling is None:
            sampling = SamplingParams(max_new_tokens=max_new_tokens,
                                      eos_id=eos_id)
        req = Request(next(self._next_id), list(prompt),
                      sampling.max_new_tokens, sampling.eos_id,
                      extras, sampling, sink, ctx)
        req.sampler = sampling.sampler()
        req.base_key = (np.asarray(rng_key, np.uint32)
                        if rng_key is not None
                        else base_key(sampling.resolve_seed()))
        if resume_output:
            req.output = list(resume_output)
        req.submitted_at = time.perf_counter()
        req.trace = getattr(ctx, "trace", None)
        if req.trace is not None:
            req.trace.event("scheduler_queued", t=req.submitted_at,
                            req_id=req.req_id, priority=req.priority,
                            pending=self.pending)
        self._queue_for(req).append(req)
        self.pending_high_water = max(self.pending_high_water, self.pending)
        return req

    def _queue_for(self, req: Request) -> Deque[Request]:
        return self.bulk_queue if req.priority == "bulk" else self.queue

    def cancel(self, req: Request) -> bool:
        """Abandon a request: a queued or parked one is finalized
        immediately, an active one is evicted (slot freed) at the next
        tick.  Returns whether there was anything left to cancel."""
        with self.lock:
            if req.done:
                return False
            req.cancelled = True
            if not self._unqueue(req):
                return True                # active in a slot: reaped in step()
            self._finish(req, "cancelled", time.perf_counter())
            self._notify(req, None)
            return True

    def _unqueue(self, req: Request) -> bool:
        """Take ``req`` out of the pending deques or the parked list (the
        caller holds ``lock``); False if it is in none of them."""
        for q in (self.queue, self.bulk_queue, self.parked):
            try:
                q.remove(req)
            except ValueError:
                continue
            return True
        return False

    def pause(self, req: Request) -> None:
        """Request preemption: the slot is parked at the next tick (the
        stalled stream stops costing decode steps)."""
        if not req.done:
            req.paused = True

    def resume(self, req: Request) -> bool:
        """Un-park a preempted request: it re-enters the FRONT of its
        priority deque (it already waited) and is re-admitted."""
        with self.lock:
            req.paused = False
            try:
                self.parked.remove(req)
            except ValueError:
                return False  # never actually parked (flag raced) or done
            if req.done:
                return False
            if req.trace is not None:
                req.trace.event("resume", req_id=req.req_id,
                                fast=bool(req.pages))
            self._queue_for(req).appendleft(req)
            return True

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.bulk_queue)

    def idle(self) -> bool:
        return self.active == 0 and not self.queue and not self.bulk_queue

    # --- one scheduler tick ------------------------------------------------------

    def step(self) -> List[Request]:
        """Reap cancellations/pauses/expiries + admit-from-queue + one
        decode step.  Returns every request that finished during this
        tick."""
        if self.faults is not None:
            self.faults.fire("decode_tick", tick=self.steps)
        t_tick = time.perf_counter()
        finished = self._reap()
        prefill_s = self._admit(finished)
        self.prefill_s_total += prefill_s
        if self.paged:
            self._ensure_decode_pages()
        if self.active == 0:
            return finished
        if self.faults is not None:
            # a poisoned device step: raises after admission so the
            # in-flight batch takes the failure
            self.faults.fire("engine_step", tick=self.steps)
        if self.paged:
            self._sync_paged_state()
        spec_w = self._spec_window_for_tick()
        t_dev = time.perf_counter()
        draws = counts = None
        if self.device_sampling:
            # decode + on-device sampling: ONLY the (num_slots,) token-id
            # vector crosses to host this tick.  Sampling params, token
            # ids and rng counters are uploaded only when a slot changed
            # hands; steady-state ticks upload nothing.
            if self._samp_dev is None:
                up = self._up
                self._samp_dev = {
                    "temperature": up("temperature", self._temps),
                    "top_k": up("top_k", self._top_ks),
                    "top_p": up("top_p", self._top_ps),
                    "key": up("key", self._keys),
                    "regime": sampling_regime(self._temps, self._top_ks,
                                              self._top_ps, self._vocab)}
                self._tok_dev = up("token", self._last_token)
                self._ctr_dev = up("ctr", self._ctr)
                if self.speculative:
                    self._spec_dev = up("spec_on", self._spec_on)
            if spec_w is not None:
                # draft scan + verify + accept: the host gets the
                # (num_slots, w) draws and (num_slots,) counts, int32, in
                # one copy — never logits
                (draws_dev, counts_dev, tok_dev, self.state,
                 ctr_dev) = self.engine.speculative_step(
                    spec_w, self._tok_dev, self.state, self._samp_dev,
                    self._ctr_dev, self._spec_dev)
                both = torch.cat([draws_dev, counts_dev[:, None]], dim=1)
                both = both.cpu().numpy()            # blocks: device sync
                draws, counts = both[:, :spec_w], both[:, spec_w]
                transfer = both.nbytes
                tokens = None
            else:
                tok_dev, self.state, ctr_dev = self.engine.decode_sample(
                    self._tok_dev, self.state, self._samp_dev,
                    self._ctr_dev)
                tokens = tok_dev.cpu().numpy()       # blocks: device sync
                transfer = tokens.nbytes
            host = greedy = None
        else:
            token = self._up("token", self._last_token)
            # reference host path: full logits cross when any slot samples
            logits, self.state = self.engine.decode(token, self.state)
            if all(req is None or req.sampler.params.greedy
                   for req in self.slots):
                host = None
                greedy = torch.argmax(logits, dim=-1).to(
                    torch.int32).cpu().numpy()
                transfer = greedy.nbytes
            else:
                host_t = logits.cpu()                # (num_slots, V)
                transfer = host_t.numel() * host_t.element_size()
                host = host_t.float().numpy()
                greedy = None
            tokens = None
        device_s = time.perf_counter() - t_dev
        self.steps += 1
        self.decode_ticks += 1
        self.decode_transfer_bytes += transfer
        if self.speculative:
            self._spec_account(spec_w, counts, device_s)
        self._push(self.tick_transfer_window, transfer)
        # per-request decode accounting: the tick's device/transfer cost
        # splits evenly across the slots that shared it, accumulated ONCE
        # per tick; each request flushes its attach->detach delta
        inv = 1.0 / self.active
        self._share_ticks += 1
        self._share_device_ms += 1e3 * device_s * inv
        self._share_transfer += transfer * inv
        if spec_w is not None:
            d_ms = 1e3 * device_s * self.engine.draft_share
            self._share_draft_ms += d_ms * inv
            self._share_verify_ms += (1e3 * device_s - d_ms) * inv
        self.decode_device_ms_total += 1e3 * device_s
        now = time.perf_counter()
        free_later: List[int] = []
        done_later: List[Tuple[Request, int]] = []
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            if draws is not None:
                # row b emitted its accepted window (the last entry is the
                # verify's own draw: the correction token on a rejection,
                # the bonus token on full acceptance)
                emitted = [int(t) for t in draws[b, :counts[b]]]
                if self._spec_on[b]:
                    req.spec_proposed += spec_w - 1
                    req.spec_accepted += int(counts[b]) - 1
                    if req.trace is not None:
                        req.trace.bump("spec_proposed", spec_w - 1)
                        req.trace.bump("spec_accepted", int(counts[b]) - 1)
            elif tokens is not None:
                emitted = [int(tokens[b])]
            else:
                emitted = [int(greedy[b]) if host is None
                           else req.sampler.sample(host[b])]
            reason = None
            for t in emitted:
                self._record_token(req, t, now)
                reason = self._finish_reason(req, t)
                if reason is not None:
                    # mid-window finish: the device advanced the whole
                    # accepted count, but the slot frees below and the
                    # next admission re-uploads its state
                    self._finish(req, reason, now)
                    finished.append(req)
                    free_later.append(b)
                    done_later.append((req, t))
                    break
                self._notify(req, t)
            if reason is None:
                self._last_token[b] = emitted[-1]
                self._ctr[b] = len(req.output)
                if self.paged:
                    # mirror the device's per-row length advance for
                    # continuing rows (no re-upload while nothing else
                    # changes)
                    self._lengths[b] += len(emitted)
        if self.device_sampling and self._samp_dev is not None:
            # no slot changed hands: next tick's inputs never leave the
            # device (a finish this tick clears _samp_dev via the deferred
            # _free_slot below, falling back to a re-upload from the
            # mirrors)
            self._tok_dev, self._ctr_dev = tok_dev, ctr_dev
        self._push(self.device_ms_window, 1e3 * device_s)
        self._push(self.prefill_ms_window, 1e3 * prefill_s)
        host_ms = 1e3 * max(0.0, (time.perf_counter() - t_tick)
                            - device_s - prefill_s)
        self._push(self.host_ms_window, host_ms)
        h = self.hist
        h["decode_device_ms"].observe(1e3 * device_s)
        h["decode_host_ms"].observe(host_ms)
        h["prefill_ms"].observe(1e3 * prefill_s)
        h["tick_transfer_bytes"].observe(transfer)
        # the host cost is shared by the slots that decoded this tick;
        # finished slots are freed only BELOW, after this accrual, so a
        # finishing request's flush still carries its final-tick share
        self._share_host_ms += host_ms * inv
        self.decode_host_ms_total += host_ms
        for b in free_later:
            self._free_slot(b)
        # a finished request's last token reaches its sink only after its
        # slot's flush has put the decode counters on its trace, so a
        # caller that reads the trace as the stream ends finds them
        for req, t in done_later:
            self._notify(req, t)
        return finished

    def run(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.idle():
                break
            self.step()
        return self.completed

    # --- admission -----------------------------------------------------------------

    def _pop_next(self) -> Optional[Request]:
        """Weighted round-robin between the priority deques: while BOTH
        classes wait, interactive wins ``interactive_weight`` admissions
        per bulk admission.  The credit only accrues against waiting bulk
        work."""
        hi, lo = self.queue, self.bulk_queue
        if not lo:
            self._rr_credit = 0
            return self._pop_fair(hi) if hi else None
        if hi and self._rr_credit < self.interactive_weight:
            self._rr_credit += 1
            return self._pop_fair(hi)
        self._rr_credit = 0
        return self._pop_fair(lo)

    @staticmethod
    def _client_of(req: Request) -> Optional[str]:
        return getattr(req.ctx, "client", None)

    def _pop_fair(self, dq: Deque[Request]) -> Request:
        """Pop the next request from ``dq`` under per-client start-time
        fair queueing.  Single-client deques take the plain FIFO path;
        with competing tags, the client with the LOWEST virtual clock pops
        its oldest request and advances its clock by cost/weight (cost =
        prompt + decode budget in tokens).  Clocks renormalize to the
        winner's clock, so an idle client re-enters at "now"."""
        first_c = self._client_of(dq[0])
        firsts: Dict[Optional[str], int] = {}   # tag -> oldest index
        multi = False
        for i, req in enumerate(dq):
            c = self._client_of(req)
            if c not in firsts:
                firsts[c] = i
                if c != first_c:
                    multi = True
        if not multi:                       # one distinct client: FIFO
            return dq.popleft()
        floor = min(self._client_vt.get(c, 0.0) for c in firsts)
        for c, i in firsts.items():
            if self._client_vt.get(c, 0.0) > floor:
                continue
            req = dq[i]
            del dq[i]
            cost = float(len(req.prompt) + req.max_new_tokens)
            w = self.client_weights.get(c, 1.0) if c else 1.0
            self._client_vt[c] = floor + cost / max(w, 1e-9)
            if len(self._client_vt) > 4096:  # bounded against tag churn
                self._client_vt.clear()
            return req
        return dq.popleft()                  # unreachable

    def _drop_expired(self, req: Request, now: float,
                      finished: List[Request]) -> bool:
        """Drop an expired request BEFORE its prefill forward: the deadline
        is honored at the hand-off, not after the work is spent."""
        if not req.expired(now):
            return False
        self.deadline_total += 1
        if req.trace is not None:
            req.trace.event("deadline_drop", t=now, stage="scheduler_admit",
                            req_id=req.req_id)
        self._finish(req, "deadline", now)
        finished.append(req)
        self._notify(req, None)
        return True

    def _fail(self, req: Request, err: BaseException, now: float,
              finished: List[Request]) -> None:
        req.error = err
        self._finish(req, "error", now)
        finished.append(req)
        self._notify(req, None)

    def _admit(self, finished: List[Request]) -> float:
        """Admit up to one pending request per free slot, batching the
        prefill forwards: popped requests are grouped by prefill signature
        (sequence bucket + extras signature) and each group runs ONE
        bucketed forward.  Returns seconds spent on prefill forwards."""
        free = [b for b in range(self.num_slots) if self.slots[b] is None]
        if not free:
            return 0.0
        if self.paged:
            return self._admit_paged(finished, free)
        picked: List[Tuple[Request, int, Tuple]] = []
        while len(picked) < len(free):
            with self.lock:
                req = self._pop_next()
            if req is None:
                break
            now = time.perf_counter()
            if self._drop_expired(req, now, finished):
                continue
            try:
                S = self.engine.seq_buckets.bucket_for(
                    len(req.prompt) + len(req.output))
            except ValueError as err:
                # no longer fits a sequence bucket (resumed request grew
                # past max_len): fail it, keep admitting
                self._fail(req, err, now, finished)
                continue
            picked.append((req, S, self._extras_signature(req)))
        if not picked:
            return 0.0
        self._admitting = [req for req, _, _ in picked]
        groups: Dict[Tuple, List[Request]] = {}
        for req, S, esig in picked:
            groups.setdefault((S, esig), []).append(req)
        prefill_s = 0.0
        for (S, _), reqs in groups.items():
            for i in range(0, len(reqs), self.max_prefill_batch):
                prefill_s += self._prefill_group(
                    reqs[i:i + self.max_prefill_batch], S, free, finished)
        self._admitting = []
        return prefill_s

    @staticmethod
    def _extras_signature(req: Request) -> Tuple:
        if not req.extras:
            return ()
        return tuple(sorted(
            (k, np.asarray(v).shape, str(np.asarray(v).dtype))
            for k, v in req.extras.items()))

    def _first_tokens(self, reqs: List[Request], B: int, logits) -> Any:
        """Each group row's first token: sampled on the device (only the
        (B,) ids cross) or, on the host path, from host logits."""
        if self.device_sampling:
            temps = np.zeros((B,), np.float32)
            top_ks = np.zeros((B,), np.int32)
            top_ps = np.ones((B,), np.float32)
            keys = np.zeros((B, 2), np.int64)
            ctr = np.zeros((B,), np.int32)
            for i, req in enumerate(reqs):
                p = req.sampler.params
                temps[i], top_ks[i], top_ps[i] = (p.temperature, p.top_k,
                                                  p.top_p)
                keys[i] = req.base_key
                ctr[i] = len(req.output)
            up = self._up
            samp = {"temperature": up("g_temperature", temps),
                    "top_k": up("g_top_k", top_ks),
                    "top_p": up("g_top_p", top_ps),
                    "key": up("g_key", keys),
                    "regime": sampling_regime(temps, top_ks, top_ps,
                                              self._vocab)}
            firsts = self.engine.sample(logits, samp,
                                        up("g_ctr", ctr)).cpu().numpy()
            self.prefill_transfer_bytes += firsts.nbytes
            return firsts
        host_t = logits.cpu()                               # (B, V)
        self.prefill_transfer_bytes += host_t.numel() * host_t.element_size()
        host = host_t.float().numpy()
        return [reqs[i].sampler.sample(host[i]) for i in range(len(reqs))]

    def _attach(self, req: Request, b: int, first: int) -> None:
        """Land a request in slot ``b``: its sampling row and mirrors."""
        self.slots[b] = req
        self._mark_share(req)
        self._last_token[b] = first
        self._ctr[b] = len(req.output)
        p = req.sampler.params
        self._temps[b] = p.temperature
        self._top_ks[b] = p.top_k
        self._top_ps[b] = p.top_p
        self._keys[b] = req.base_key
        self._spec_on[b] = p.speculation
        self._samp_dev = None                # re-upload on the next tick

    def _prefill_group(self, reqs: List[Request], S: int,
                       free: List[int], finished: List[Request]) -> float:
        """One bucketed prefill forward for a same-signature group (each
        request's prompt + any output decoded before a pause — recompute
        preemption), first tokens sampled on device, and every surviving
        row inserted into the pooled state by one gather-scatter."""
        if self.faults is not None:
            self.faults.fire("prefill", group=len(reqs))
        n = len(reqs)
        B = self.engine.batch_buckets.bucket_for(n)
        tokens = np.zeros((B, S), np.int32)
        lengths = np.ones((B,), np.int32)
        for i, req in enumerate(reqs):
            seed = req.prompt + req.output
            tokens[i, :len(seed)] = seed
            lengths[i] = len(seed)
            self.prefill_tokens_total += len(seed)
            if req.trace is not None:
                req.trace.bump("prefill_tokens", len(seed))
        up = self._up
        batch = {"tokens": up("p_tokens", tokens),
                 "lengths": up("p_lengths", lengths)}
        if reqs[0].extras:
            for k in reqs[0].extras:
                stacked = np.stack([np.asarray(r.extras[k]) for r in reqs])
                if B > n:
                    pad = [(0, B - n)] + [(0, 0)] * (stacked.ndim - 1)
                    stacked = np.pad(stacked, pad)
                batch[k] = up(f"p_{k}", stacked)
        t0 = time.perf_counter()
        for req in reqs:
            self._span_queue_wait(req, t0)
        group_state = self.engine.new_state(B)
        logits, group_state = self.engine.prefill(batch, group_state)
        self.prefill_forwards += 1
        self.prefill_requests += n
        firsts = self._first_tokens(reqs, B, logits)
        prefill_s = time.perf_counter() - t0
        now = time.perf_counter()
        src_rows = np.zeros((self.num_slots,), np.int64)
        write_mask = np.zeros((self.num_slots,), bool)
        landed = False
        for i, req in enumerate(reqs):
            first = int(firsts[i])
            self._record_token(req, first, now)
            reason = self._finish_reason(req, first)
            if reason is not None:   # stop/budget hit on the very first
                self._finish(req, reason, now)
                finished.append(req)
            else:
                b = free.pop(0)
                self._attach(req, b, first)
                src_rows[b] = i
                write_mask[b] = True
                landed = True
        if landed:
            t1 = time.perf_counter()
            self.state = self.engine.insert_rows(
                self.state, group_state, up("src_rows", src_rows),
                up("write_mask", write_mask))
            prefill_s += time.perf_counter() - t1
        t_end = time.perf_counter()
        per_ms = 1e3 * prefill_s / n         # even split: one forward, n rows
        for req in reqs:                     # every row got its first token
            if req.trace is not None:
                req.trace.span("prefill", t0, t_end,
                               group_size=n, seq_bucket=S)
                req.trace.bump("prefill_ms", per_ms)
            self._notify(req, req.output[-1])
        return prefill_s

    # --- paged admission ---------------------------------------------------------

    def _admit_paged(self, finished: List[Request],
                     free: List[int]) -> float:
        """Paged-engine admission.  A previously-parked request that still
        OWNS pages reattaches O(1): its slot's page-table row is re-pointed
        at the pinned pages, no prefill forward, no recompute.  A fresh
        request first matches its prompt against the prefix cache (shared
        full pages join its table by reference), then allocates pages for
        the remaining suffix only.  Allocation failure requeues the
        request at the FRONT and stops admitting — pages free up as active
        requests finish."""
        ps = self.engine.page_size
        picked: List[Tuple[Request, PrefixMatch, List[int],
                           List[int], int, int]] = []
        while len(picked) < len(free):
            with self.lock:
                req = self._pop_next()
            if req is None:
                break
            now = time.perf_counter()
            if self._drop_expired(req, now, finished):
                continue
            if req.pages is not None:        # parked with pages pinned
                self._reattach(req, free.pop(0))
                continue
            seed = req.prompt + req.output
            match = self.pager.match_prefix(seed)
            suffix = seed[match.ctx_tokens:]
            try:
                S = self.engine.seq_buckets.bucket_for(len(suffix))
            except ValueError as err:
                # cannot happen for requests this scheduler finished
                # correctly (max_len ends them first) — defensive
                self.pager.release(match.pages)
                self._fail(req, err, now, finished)
                continue
            need = -(-len(seed) // ps) - len(match.pages)
            try:
                new_pages = self.pager.alloc(need)
            except PagerOOM:
                self.pager.release(match.pages)
                with self.lock:
                    self._queue_for(req).appendleft(req)
                break
            C = self.engine.ctx_bucket_for(len(match.pages))
            req.pages = list(match.pages) + list(new_pages)
            picked.append((req, match, new_pages, suffix, S, C))
        if not picked:
            return 0.0
        self._admitting = [item[0] for item in picked]
        groups: Dict[Tuple[int, int], List] = {}
        for item in picked:
            groups.setdefault((item[4], item[5]), []).append(item)
        prefill_s = 0.0
        for (S, C), items in groups.items():
            for i in range(0, len(items), self.max_prefill_batch):
                prefill_s += self._prefill_group_paged(
                    items[i:i + self.max_prefill_batch], S, C, free,
                    finished)
        self._admitting = []
        return prefill_s

    def _prefill_group_paged(self, items: List, S: int, C: int,
                             free: List[int],
                             finished: List[Request]) -> float:
        """One bucketed SUFFIX prefill for a same-(seq, ctx)-bucket group:
        each row's suffix attends to its shared context pages and commits
        its K/V straight into its freshly allocated pool pages — no group
        state, no slot scatter.  Newly completed full pages are published
        to the prefix cache so identical prefixes prefill once."""
        if self.faults is not None:
            self.faults.fire("prefill", group=len(items))
        ps = self.engine.page_size
        n = len(items)
        B = self.engine.batch_buckets.bucket_for(n)
        nc = -(-S // ps)
        tokens = np.zeros((B, S), np.int32)
        lengths = np.ones((B,), np.int32)
        ctx_table = np.zeros((B, C), np.int32)
        ctx_lens = np.zeros((B,), np.int32)
        dest = np.zeros((B, nc), np.int32)
        for i, (req, match, new_pages, suffix, _, _) in enumerate(items):
            tokens[i, :len(suffix)] = suffix
            lengths[i] = len(suffix)
            ctx_table[i, :len(match.pages)] = match.pages
            ctx_lens[i] = match.ctx_tokens
            dest[i, :len(new_pages)] = new_pages
        t0 = time.perf_counter()
        for req, *_ in items:
            self._span_queue_wait(req, t0)
        up = self._up
        logits, self.state = self.engine.paged_prefill(
            self.state, up("p_tokens", tokens), up("p_lengths", lengths),
            up("p_ctx_table", ctx_table), up("p_ctx_lens", ctx_lens),
            up("p_dest", dest))
        self.prefill_forwards += 1
        self.prefill_requests += n
        reqs = [item[0] for item in items]
        firsts = self._first_tokens(reqs, B, logits)
        prefill_s = time.perf_counter() - t0
        per_ms = 1e3 * prefill_s / n         # even split: one forward, n rows
        now = time.perf_counter()
        for i, (req, match, new_pages, suffix, _, _) in enumerate(items):
            if req.trace is not None:
                req.trace.span("prefill", t0, now, group_size=n,
                               seq_bucket=S, ctx_bucket=C,
                               prefix_reused_tokens=match.ctx_tokens,
                               suffix_tokens=len(suffix))
                # attribution counts the tokens actually FORWARDED — a
                # prefix-cache hit is not billed to the reusing client
                req.trace.bump("prefill_tokens", len(suffix))
                req.trace.bump("prefill_ms", per_ms)
            seed = req.prompt + req.output
            # publish BEFORE the first-token finish check: even a request
            # that stops immediately leaves its prefix behind for reuse
            self.pager.register_prefix(seed, req.pages)
            self.prefill_tokens_forwarded += len(suffix)
            self.prefill_tokens_reused += match.ctx_tokens
            self.prefill_tokens_total += len(suffix)
            first = int(firsts[i])
            self._record_token(req, first, now)
            reason = self._finish_reason(req, first)
            if reason is not None:
                self._finish(req, reason, now)
                finished.append(req)
            else:
                b = free.pop(0)
                self._attach(req, b, first)
                self._table[b] = 0
                self._table[b, :len(req.pages)] = req.pages
                self._lengths[b] = len(seed)    # next write position
                self._state_dirty = True
        for req in reqs:
            self._notify(req, req.output[-1])
        return prefill_s

    def _reattach(self, req: Request, b: int) -> None:
        """O(1) resume of a parked request that kept its pages: re-point
        slot ``b``'s page-table row at them and restore the sampling
        mirrors.  No prefill forward runs and no K/V is recomputed — the
        rng counter (= tokens produced) keeps the seeded stream exactly
        where it left off."""
        self._attach(req, b, req.output[-1])
        self._table[b] = 0
        self._table[b, :len(req.pages)] = req.pages
        self._lengths[b] = len(req.prompt) + len(req.output) - 1
        self._state_dirty = True
        self.resumes_fast += 1
        if req.trace is not None:
            req.trace.event("reattach", req_id=req.req_id,
                            pages=len(req.pages))

    def _ensure_decode_pages(self) -> None:
        """Before a decode tick, make sure every active slot owns the pages
        its next tokens land in; allocate on the boundary.  A plain tick
        writes one position; a speculative engine may commit up to
        max_window positions a tick, so its slots keep the whole window
        covered (clamped at the per-sequence table: positions past max_len
        go to the dump page, and the request finishes with reason "length"
        before they could matter).  When the pool is dry even after cache
        eviction, RECOMPUTE-preempt the slot: release its pages and
        requeue it at the front (the O(1) reattach path doesn't apply —
        its pages are gone)."""
        ps = self.engine.page_size
        lookahead = self.engine.max_window if self.speculative else 1
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            need = min(int(self._lengths[b] + lookahead - 1) // ps + 1,
                       self.engine.max_pages_per_seq)
            while len(req.pages) < need:
                try:
                    pg = self.pager.alloc(1)
                except PagerOOM:
                    self._release_pages(req)
                    self._free_slot(b)
                    with self.lock:
                        self._queue_for(req).appendleft(req)
                    self.preempt_recompute += 1
                    if req.trace is not None:
                        req.trace.event("preempt", req_id=req.req_id,
                                        cause="pager_oom", recompute=True)
                    break
                req.pages.extend(pg)
                self._table[b, len(req.pages) - 1] = pg[0]
                self._state_dirty = True

    def _sync_paged_state(self) -> None:
        """Upload the host page-table/length mirrors when dirty.  While no
        slot changes hands the device is self-consistent (its decode step
        advances lengths in lockstep with the host mirrors), so
        steady-state ticks upload nothing."""
        if not self._state_dirty:
            return
        self.state["page_table"] = self._up("page_table", self._table)
        self.state["length"] = self._up("length", self._lengths)
        self._state_dirty = False

    def _release_pages(self, req: Request) -> None:
        if req.pages:
            self.pager.release(req.pages)
        req.pages = None

    def pager_stats(self) -> Optional[Dict[str, Any]]:
        if not self.paged:
            return None
        return {**self.pager.stats(),
                "resumes_without_recompute": self.resumes_fast,
                "preempt_recompute": self.preempt_recompute,
                "prefill_tokens_forwarded": self.prefill_tokens_forwarded,
                "prefill_tokens_reused": self.prefill_tokens_reused}

    # --- speculative decoding ----------------------------------------------------

    def _spec_window_for_tick(self) -> Optional[int]:
        """This tick's verify window, or None for a plain tick.  Level 0
        is the plain tick, with a probe tick every SPEC_PROBE_INTERVAL so
        the controller can climb back when acceptance recovers."""
        if not self.speculative:
            return None
        if not any(self._spec_on[b] and self.slots[b] is not None
                   for b in range(self.num_slots)):
            return None                  # every active slot opted out
        if self._spec_level == 0:
            self._spec_probe -= 1
            if self._spec_probe > 0:
                return None
            self._spec_probe = SPEC_PROBE_INTERVAL
            return self._spec_levels[1]
        return self._spec_levels[self._spec_level]

    def _spec_account(self, spec_w: Optional[int], counts: Optional[Any],
                      device_s: float) -> None:
        """Per-tick speculation bookkeeping and the adaptive-k update.  The
        draft/verify device-ms split is an ESTIMATE prorated by the pair's
        parameter bytes (the tick's device time is measured as one)."""
        if spec_w is None:
            self.spec_k_hist[1] += 1
            return
        self.spec_ticks += 1
        self.spec_k_hist[spec_w] += 1
        draft_ms = 1e3 * device_s * self.engine.draft_share
        self.spec_draft_ms_total += draft_ms
        self.spec_verify_ms_total += 1e3 * device_s - draft_ms
        spec_rows = [b for b in range(self.num_slots)
                     if self.slots[b] is not None and self._spec_on[b]]
        n = len(spec_rows)
        proposed = n * (spec_w - 1)
        accepted = int(counts[spec_rows].sum()) - n
        self.spec_proposed_total += proposed
        self.spec_accepted_total += accepted
        if proposed > 0:
            rate = accepted / proposed
            self._accept_ema += SPEC_EMA_ALPHA * (rate - self._accept_ema)
            if self._accept_ema < SPEC_LOW_WATER and self._spec_level > 0:
                self._spec_level -= 1
                if self._spec_level == 0:
                    self._spec_probe = SPEC_PROBE_INTERVAL
            elif (self._accept_ema > SPEC_HIGH_WATER
                  and self._spec_level < len(self._spec_levels) - 1):
                self._spec_level += 1

    def speculation_stats(self) -> Optional[Dict[str, Any]]:
        if not self.speculative:
            return None
        proposed = self.spec_proposed_total
        return {
            "enabled": True,
            "max_window": self.engine.max_window,
            "window": self._spec_levels[self._spec_level],
            "acceptance_ema": self._accept_ema,
            "spec_ticks": self.spec_ticks,
            "proposed_tokens": proposed,
            "accepted_tokens": self.spec_accepted_total,
            "acceptance_rate": (self.spec_accepted_total / proposed
                                if proposed else 0.0),
            "k_hist": {str(w): c for w, c in self.spec_k_hist.items()},
            "draft_ms_total": self.spec_draft_ms_total,
            "verify_ms_total": self.spec_verify_ms_total,
            "draft_share_estimate": self.engine.draft_share,
        }

    # --- internals -------------------------------------------------------------

    def _mark_share(self, req: Request) -> None:
        """Slot ATTACH hook: snapshot the cumulative share accumulators.
        Untraced requests carry no mark, so attach/detach stay free for
        them."""
        if req.trace is not None:
            req.share_mark = (self._share_ticks, self._share_device_ms,
                              self._share_host_ms, self._share_transfer,
                              self._share_draft_ms, self._share_verify_ms)

    def _flush_share(self, req: Request) -> None:
        """Slot DETACH hook: fold the attach->detach accumulator delta into
        the request's trace counters.  Idempotent — the mark is consumed,
        and a later re-attach lays down a fresh one."""
        m, req.share_mark = req.share_mark, None
        if m is None or req.trace is None:
            return
        ticks = self._share_ticks - m[0]
        if ticks:
            tr = req.trace
            tr.bump("decode_ticks", ticks)
            tr.bump("decode_device_ms", self._share_device_ms - m[1])
            tr.bump("decode_host_ms", self._share_host_ms - m[2])
            tr.bump("decode_transfer_bytes", self._share_transfer - m[3])
            draft = self._share_draft_ms - m[4]
            if draft:                    # speculative ticks in residency
                tr.bump("decode_draft_ms", draft)
                tr.bump("decode_verify_ms", self._share_verify_ms - m[5])

    def _free_slot(self, b: int) -> None:
        """Release slot ``b`` and reset its sampling-param row to greedy,
        so a batch of remaining greedy slots regains the argmax path."""
        req = self.slots[b]
        if req is not None:
            self._flush_share(req)
        self.slots[b] = None
        self._temps[b] = 0.0
        self._top_ks[b] = 0
        self._top_ps[b] = 1.0
        self._keys[b] = 0
        self._spec_on[b] = False
        self._samp_dev = None
        if self.paged:
            # zero the table row so the vacant slot's decode-step writes
            # land in the dump page, never in someone's live pages
            self._table[b] = 0
            self._lengths[b] = 0
            self._state_dirty = True

    def _reap(self) -> List[Request]:
        """Evict cancelled, paused (preempted, NOT finished), and
        deadline-expired slot occupants before the next decode step."""
        reaped = []
        now = time.perf_counter()
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            if req.cancelled:
                self._free_slot(b)
                self._finish(req, "cancelled", now)
                self._notify(req, None)
                reaped.append(req)
            elif req.paused:
                with self.lock:      # a resume/retire may race the park
                    if not req.paused:
                        pass                 # resumed meanwhile
                    elif not self.preempt_enabled:
                        req.paused = False   # retiring: decode in place
                    else:
                        self._free_slot(b)
                        self.parked.append(req)
                        req.pause_count += 1
                        self.pauses_total += 1
                        if req.trace is not None:
                            req.trace.event("preempt", t=now,
                                            req_id=req.req_id,
                                            cause="stalled_consumer",
                                            pause_count=req.pause_count)
            elif req.expired(now):
                self._free_slot(b)
                self.deadline_total += 1
                self._finish(req, "deadline", now)
                self._notify(req, None)
                reaped.append(req)
        reaped.extend(self.reap_parked_expired(now))
        return reaped

    def reap_parked_expired(self, now: Optional[float] = None
                            ) -> List[Request]:
        """Deadline-drop parked (preempted) requests.  Called from step()
        AND from the idle driver loop — a parked request keeps the
        scheduler idle(), so step() alone would never scan it."""
        if not self.parked:
            return []
        now = now if now is not None else time.perf_counter()
        reaped, still = [], []
        with self.lock:
            for req in self.parked:
                if req.done:
                    continue               # cancelled elsewhere
                if req.expired(now):
                    self.deadline_total += 1
                    self._finish(req, "deadline", now)
                    self._notify(req, None)
                    reaped.append(req)
                else:
                    still.append(req)
            self.parked = still
        return reaped

    def _finish_reason(self, req: Request, token: int) -> Optional[str]:
        if req.sampler.is_stop(token):
            return "stop" if (req.eos_id is None
                              or token != req.eos_id) else "eos"
        if len(req.output) >= req.max_new_tokens:
            return "length"
        if len(req.prompt) + len(req.output) >= self.engine.max_len:
            # cache exhausted: the NEXT token would write at position
            # max_len
            return "length"
        return None

    def _span_queue_wait(self, req: Request, t_admit: float) -> None:
        """Record the submit->admit interval on the request's trace and in
        the queue-wait histogram (exemplar = this trace)."""
        wait_ms = 1e3 * (t_admit - req.submitted_at)
        tid = None
        if req.trace is not None:
            req.trace.span("queue_wait", req.submitted_at, t_admit,
                           req_id=req.req_id, priority=req.priority)
            tid = req.trace.trace_id
        self.hist["queue_wait_ms"].observe(wait_ms, tid)

    def _record_token(self, req: Request, token: int, now: float) -> None:
        req.output.append(token)
        self.decode_tokens_total += 1
        tid = req.trace.trace_id if req.trace is not None else None
        if req.trace is not None:
            req.trace.bump("decode_tokens")
        if req.first_token_at is None:
            req.first_token_at = now
            ttft = now - req.submitted_at
            self.ttft_res.add(ttft)
            self.hist["ttft_ms"].observe(1e3 * ttft, tid)
            if req.trace is not None:
                req.trace.event("first_token", t=now, req_id=req.req_id)
        else:
            gap = now - req.last_token_at
            self.itl_res.add(gap)
            self.hist["inter_token_ms"].observe(1e3 * gap, tid)
        req.last_token_at = now

    def _finish(self, req: Request, reason: str, now: float) -> None:
        self._close(req, reason, now)
        self._account(req, reason, now)

    @staticmethod
    def _close(req: Request, reason: str, now: float) -> None:
        """The request's own side of a finish: its state and its trace's
        ``request_finished`` event."""
        req.done = True
        req.finish_reason = reason
        req.finished_at = now
        if req.trace is not None:
            req.trace.event("request_finished", t=now, req_id=req.req_id,
                            reason=reason, tokens=len(req.output))

    def _account(self, req: Request, reason: str, now: float) -> None:
        """The scheduler's side of a finish (the driver thread's): pages,
        counters, the completed window, latency samples."""
        if self.paged:
            # every terminal path funnels through here — slot finishes,
            # cancels, deadlines (queued, active, or parked), errors —
            # so page references cannot leak
            self._release_pages(req)
        if reason == "cancelled":
            self.cancelled_total += 1
        self.completed_total += 1
        # bounded like the stat windows
        self._push(self.completed, req)
        latency = now - req.submitted_at
        self.latency_res.add(latency)
        self.hist["request_latency_ms"].observe(
            1e3 * latency, req.trace.trace_id if req.trace is not None
            else None)

    def _notify(self, req: Request, token: Optional[int]) -> None:
        if req.sink is not None:
            req.sink(req, token, req.done)

    @staticmethod
    def _push(window: List[Any], value: Any) -> None:
        window.append(value)
        if len(window) > _WINDOW:
            del window[:-_WINDOW // 2]


class SchedulerService:
    """Thread-safe front-end over ``ContinuousBatchingScheduler``.

    The scheduler itself is single-threaded by design (it mutates pooled
    device state).  The service owns ONE driver thread that ticks the
    scheduler whenever work is pending, while any number of caller threads
    ``submit_and_wait`` prompts and block on a per-request event — or
    ``submit_request`` a sink-carrying streaming request whose tokens are
    delivered as they decode.

    No caller waits for a tick in flight (see the module docstring): a
    submit appends to the pending deques under the scheduler's short
    ``lock``; ``cancel`` finishes a queued or parked request at once (the
    driver settles its pages and counters at the next tick boundary) and
    flags an active one for the next tick's reap; ``begin_retire`` and
    ``resume`` move parked requests under the same lock; ``stats()`` reads
    the snapshot the driver publishes after each tick."""

    def __init__(self, engine: InferenceEngine, num_slots: int = 4, *,
                 max_pending: Optional[int] = None,
                 interactive_weight: int = 4,
                 device_sampling: bool = True,
                 client_weights: Optional[Dict[str, float]] = None,
                 faults: Optional[Any] = None):
        self.scheduler = ContinuousBatchingScheduler(
            engine, num_slots, max_pending=max_pending,
            interactive_weight=interactive_weight,
            device_sampling=device_sampling,
            client_weights=client_weights,
            faults=faults)
        self._lock = self.scheduler.lock
        self._work = threading.Condition(self._lock)
        self._events: Dict[int, threading.Event] = {}
        self._errors: Dict[int, BaseException] = {}
        # requests a caller finished (cancelled while queued or parked)
        # whose pages and counters the driver settles at the tick boundary
        self._owed: List[Tuple[Request, float]] = []
        self._closed = False
        self._retiring = False
        # True while the driver waits with nothing to do (read under _lock)
        self._idle = False
        # health signals read LOCK-FREE by a replica monitor: driver-error
        # scoring, last completed tick's wall time, a monotonic heartbeat
        self.driver_errors = 0
        self.consecutive_errors = 0
        self.last_error: Optional[BaseException] = None
        self.last_tick_s = 0.0
        self.last_step_at = time.monotonic()
        self._snap = self._snapshot()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="flexserve-scheduler")
        self._thread.start()

    @property
    def engine(self) -> InferenceEngine:
        return self.scheduler.engine

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit_and_wait(self, prompts: Sequence[Sequence[int]], *,
                        max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        sampling: Optional[SamplingParams] = None,
                        ctx: Optional[Any] = None,
                        timeout: Optional[float] = None) -> GenerationResult:
        """Enqueue every prompt as its own slot-admissible request and block
        until all of them finish; mirrors ``engine.generate``'s result.
        ``steps`` counts scheduler ticks during this call's lifetime.  A
        seeded ``sampling`` gives row i the derived seed ``seed + i``."""
        if sampling is None:
            sampling = SamplingParams(max_new_tokens=max_new_tokens,
                                      eos_id=eos_id)
        for p in prompts:
            # reject un-admittable prompts synchronously (a caller error
            # must not reach — and kill — the driver thread)
            self.scheduler.engine.seq_buckets.bucket_for(len(p))
        with self._lock:
            if self._closed or self._retiring:
                raise RuntimeError("scheduler service is closed")
            s = self.scheduler
            if (s.max_pending is not None
                    and s.pending + len(prompts) > s.max_pending):
                # all-or-nothing: shedding half a multi-prompt request
                # would leave the caller with an un-awaitable remainder
                raise SchedulerBusy(
                    f"pending deque cannot take {len(prompts)} more "
                    f"({s.pending}/{s.max_pending})")
            steps0 = s.steps
            pairs: List[Tuple[Request, threading.Event]] = []
            for i, p in enumerate(prompts):
                req = s.submit(p, sampling=sampling.for_row(i), ctx=ctx)
                ev = threading.Event()
                self._events[req.req_id] = ev
                pairs.append((req, ev))
            self._work.notify()
        for req, ev in pairs:
            if not ev.wait(timeout=timeout):
                raise TimeoutError(f"request {req.req_id} did not finish")
        with self._lock:
            errs = [self._errors.pop(r.req_id) for r, _ in pairs
                    if r.req_id in self._errors]
        steps = self.scheduler.steps - steps0
        if errs:
            raise errs[0]
        return GenerationResult(
            tokens=[req.output for req, _ in pairs],
            prompt_lengths=[len(req.prompt) for req, _ in pairs],
            steps=steps,
            finish_reasons=[req.finish_reason for req, _ in pairs])

    def submit_request(self, prompt: Sequence[int], *,
                       sampling: SamplingParams,
                       sink: TokenSink,
                       ctx: Optional[Any] = None,
                       resume_output: Optional[Sequence[int]] = None,
                       rng_key: Optional[np.ndarray] = None,
                       on_reassign: Optional[Callable[[Request], None]]
                       = None) -> Request:
        """Admit one streaming request; its ``sink`` fires per token from
        the driver thread (it must never block).  ``resume_output``/
        ``rng_key`` is the failover-resume path (see ``submit``);
        ``on_reassign`` is accepted for interface parity with a replica
        pool — a single service never reassigns."""
        del on_reassign
        self.scheduler.engine.seq_buckets.bucket_for(
            len(prompt) + len(resume_output or ()))
        with self._lock:
            if self._closed or self._retiring:
                raise RuntimeError("scheduler service is closed")
            req = self.scheduler.submit(prompt, sampling=sampling,
                                        sink=sink, ctx=ctx,
                                        resume_output=resume_output,
                                        rng_key=rng_key)
            self._work.notify()
            return req

    def cancel(self, req: Request) -> bool:
        """Cancel a request.  A queued or parked one finishes at once (its
        sink and waiter fire here); an active one frees its slot at the
        next tick.  Returns whether there was anything left to cancel."""
        with self._lock:
            if req.done:
                return False
            req.cancelled = True
            s = self.scheduler
            if s._unqueue(req):
                now = time.perf_counter()
                s._close(req, "cancelled", now)
                self._owed.append((req, now))
                s._notify(req, None)
                ev = self._events.pop(req.req_id, None)
                if ev is not None:
                    ev.set()
            self._work.notify()
            return True

    def pause(self, req: Request) -> None:
        """Preempt a request's slot at the next tick (stalled consumer)."""
        self.scheduler.pause(req)

    def resume(self, req: Request) -> bool:
        """Un-park a preempted request.  Returns whether a parked request
        was found."""
        with self._lock:
            out = self.scheduler.resume(req)
            self._work.notify()
            return out

    def warm(self, *, seq_lens: Optional[Sequence[int]] = None,
             group_sizes: Optional[Sequence[int]] = None) -> float:
        """Run the decode data path once off the hot path, so the first
        request does not pay for kernel builds, cuBLAS start-up or the
        allocator's growth: per (seq bucket x group size) one throwaway
        scheduler over the SAME engine runs a bucketed prefill, the
        first-token sampler (filtered regime: one sampled row per group),
        and a dense or paged decode tick; on a speculative pair, one
        speculative step at every window level and one plain tick, on a
        throwaway state.  Defaults: every sequence bucket, at the largest
        group this pool admits in one forward.  Returns wall seconds spent.
        (Eager PyTorch compiles nothing per shape; what this buys is
        measured as seconds, not compile counts.)"""
        t0 = time.perf_counter()
        s = self.scheduler
        e = s.engine
        if seq_lens is None:
            seq_lens = e.seq_buckets.sizes
        if group_sizes is None:
            group_sizes = [e.batch_buckets.bucket_for(
                min(s.num_slots, s.max_prefill_batch))]
        for seq_len in seq_lens:
            # land in the seq_len bucket while leaving decode headroom in
            # the cache (a full-bucket prompt + 2 decode steps would write
            # past max_len on the largest bucket)
            probe_len = max(1, min(seq_len, e.max_len - 2))
            for g in group_sizes:
                tmp = ContinuousBatchingScheduler(
                    e, s.num_slots, device_sampling=s.device_sampling)
                for i in range(g):
                    samp = SamplingParams(
                        max_new_tokens=2,
                        **({"temperature": 1.0, "top_k": 50, "top_p": 0.9,
                            "seed": 0} if i == 0 else {}))
                    tmp.submit([1 + (i % 7)] * probe_len, sampling=samp)
                tmp.run()
                del tmp
        if s.speculative:
            n, dev = s.num_slots, e.device
            samp = {"temperature": torch.zeros((n,), device=dev),
                    "top_k": torch.zeros((n,), dtype=torch.int32,
                                         device=dev),
                    "top_p": torch.ones((n,), device=dev),
                    "key": torch.zeros((n, 2), dtype=torch.int64,
                                       device=dev),
                    "regime": "greedy"}
            tok = torch.zeros((n,), dtype=torch.int32, device=dev)
            ctr = torch.zeros((n,), dtype=torch.int32, device=dev)
            on = torch.ones((n,), dtype=torch.bool, device=dev)
            st = e.new_state(n)
            for w in e.spec_levels[1:]:
                _, _, tok, st, ctr = e.speculative_step(w, tok, st, samp,
                                                        ctr, on)
            tok, st, ctr = e.decode_sample(tok, st, samp, ctr)
            del st
        if e.device.type == "cuda":
            torch.cuda.synchronize(e.device)
        return time.perf_counter() - t0

    @property
    def retiring(self) -> bool:
        return self._retiring

    def begin_retire(self) -> None:
        """Refuse NEW submissions from now on (synchronous RuntimeError).
        Set BEFORE draining: every submit either landed first — and
        drain() waits for it — or raises and is retried elsewhere.
        Preemption is disabled and any parked request is resumed, so every
        in-flight stream decodes to completion on this engine."""
        with self._lock:
            self._retiring = True
            s = self.scheduler
            s.preempt_enabled = False
            for req in list(s.parked):
                s.resume(req)
            self._work.notify()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request has finished; returns False
        on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        s = self.scheduler
        while True:
            with self._lock:
                if self._closed or (self._idle and s.idle()
                                    and not s.parked and not self._owed):
                    return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.002)

    def stats(self, lock_timeout: Optional[float] = None
              ) -> Optional[Dict[str, Any]]:
        """Scheduler stats (the JAX service's key set) from the snapshot
        the driver published after its last tick: never waits for a tick
        in flight (``lock_timeout`` is accepted for interface parity)."""
        del lock_timeout
        snap = self._snap
        lat50, lat95 = _pctls(snap["latency"], 0.50, 0.95)
        ttft50, ttft95 = _pctls(snap["ttft"], 0.50, 0.95)
        itl50, itl95 = _pctls(snap["itl"], 0.50, 0.95)
        host_ms = sorted(snap["host_ms"])
        dev_ms = sorted(snap["device_ms"])
        pre_ms = sorted(snap["prefill_ms"])
        xfer = sorted(snap["transfer"])
        h = snap["hist"]
        decode = {
            "device_sampling": snap["device_sampling"],
            "ticks": snap["ticks"],
            "host_ms_p50": pctl(host_ms, 0.50),
            "host_ms_p95": pctl(host_ms, 0.95),
            "device_ms_p50": pctl(dev_ms, 0.50),
            "device_ms_p95": pctl(dev_ms, 0.95),
            "prefill_ms_p50": pctl(pre_ms, 0.50),
            "transfer_bytes_per_tick_p50": pctl(xfer, 0.50),
            **snap["decode"],
            "host_ms_hist": h["decode_host_ms"],
            "device_ms_hist": h["decode_device_ms"],
            "prefill_ms_hist": h["prefill_ms"],
            "transfer_bytes_hist": h["tick_transfer_bytes"],
        }
        return {
            "decode": decode,
            "pager": dict(snap["pager"]),
            "speculation": dict(snap["speculation"]),
            **snap["counts"],
            "request_latency_p50_ms": 1e3 * lat50,
            "request_latency_p95_ms": 1e3 * lat95,
            "ttft_p50_ms": 1e3 * ttft50,
            "ttft_p95_ms": 1e3 * ttft95,
            "inter_token_p50_ms": 1e3 * itl50,
            "inter_token_p95_ms": 1e3 * itl95,
            "request_latency_ms_hist": h["request_latency_ms"],
            "ttft_ms_hist": h["ttft_ms"],
            "inter_token_ms_hist": h["inter_token_ms"],
            "queue_wait_ms_hist": h["queue_wait_ms"],
        }

    def _snapshot(self) -> Dict[str, Any]:
        """What ``stats()`` reads, copied on the driver thread: counters,
        copies of the windows and reservoir samples, histogram snapshots
        (the sorting is left to the reader)."""
        s = self.scheduler
        return {
            "device_sampling": s.device_sampling,
            "ticks": s.decode_ticks,
            "decode": {
                "transfer_bytes_total": s.decode_transfer_bytes,
                "prefill_transfer_bytes_total": s.prefill_transfer_bytes,
                "prefill_forwards": s.prefill_forwards,
                "prefill_requests": s.prefill_requests,
                "prefill_s_total": s.prefill_s_total,
                "device_ms_total": s.decode_device_ms_total,
                "host_ms_total": s.decode_host_ms_total,
                "decode_tokens_total": s.decode_tokens_total,
                "prefill_tokens_total": s.prefill_tokens_total,
                "compiled_steps": s.engine.decode_cache_size()},
            "counts": {
                "steps": s.steps, "active_slots": s.active,
                "pending": s.pending,
                "pending_high_water": s.pending_high_water,
                "max_pending": s.max_pending,
                "parked": len(s.parked),
                "pauses": s.pauses_total,
                "num_slots": s.num_slots,
                "completed": s.completed_total,
                "cancelled": s.cancelled_total,
                "deadline_missed": s.deadline_total},
            "host_ms": list(s.host_ms_window),
            "device_ms": list(s.device_ms_window),
            "prefill_ms": list(s.prefill_ms_window),
            "transfer": list(s.tick_transfer_window),
            "latency": list(s.latency_res.samples),
            "ttft": list(s.ttft_res.samples),
            "itl": list(s.itl_res.samples),
            "hist": {k: v.snapshot() for k, v in s.hist.items()},
            "pager": s.pager_stats() or ZERO_PAGER_STATS,
            "speculation": (s.speculation_stats()
                            or ZERO_SPECULATION_STATS),
        }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._work.notify()
        self._thread.join(timeout=5.0)

    def abandon(self) -> None:
        """Mark the service closed WITHOUT taking the lock: an idle driver
        notices within its 100ms wait tick, and a wedged one fails its
        in-flight requests whenever the stall releases."""
        self._closed = True
        self._retiring = True

    def _fail_in_flight(self, err: BaseException) -> None:
        """Fail every queued/active request (driver error or close):
        waiters get the error, streaming sinks get a terminal event.
        Runs on the driver thread, under the lock."""
        s = self.scheduler
        now = time.perf_counter()
        for req in (list(s.queue) + list(s.bulk_queue) + list(s.parked)
                    + s._admitting + [r for r in s.slots if r is not None]):
            if req.done:
                continue
            req.error = err
            s._finish(req, "error", now)
            s._notify(req, None)
        for req_id, ev in self._events.items():
            self._errors[req_id] = err
            ev.set()
        self._events.clear()
        s.queue.clear()
        s.bulk_queue.clear()
        s.parked.clear()
        s._admitting = []
        s.slots = [None] * s.num_slots
        if s.paged:
            s._table[:] = 0
            s._lengths[:] = 0
            s._state_dirty = True

    def _run(self) -> None:
        s = self.scheduler
        while True:
            with self._lock:
                while not self._closed and not self._owed and s.idle():
                    # parked requests keep the scheduler idle; their
                    # deadlines are still enforced on this slow tick
                    for req in s.reap_parked_expired():
                        if req.req_id in self._events:
                            self._events.pop(req.req_id).set()
                    self._snap = self._snapshot()
                    self._idle = True
                    self._work.wait(timeout=0.1)
                self._idle = False
                owed, self._owed = self._owed, []
                for req, now in owed:
                    s._account(req, req.finish_reason, now)
                if self._closed:
                    self._fail_in_flight(RuntimeError(
                        "scheduler service closed with requests in flight"))
                    self._snap = self._snapshot()
                    return
            if s.idle():
                continue
            try:
                t0 = time.monotonic()
                finished = s.step()
                now = time.monotonic()
                self.last_tick_s = now - t0
                self.last_step_at = now
                self.consecutive_errors = 0
            except BaseException as err:  # noqa: BLE001 — keep driving
                # Fail every in-flight request but keep the driver alive:
                # a poisoned batch must not hang future ones.
                self.driver_errors += 1
                self.consecutive_errors += 1
                self.last_error = err
                with self._lock:
                    self._fail_in_flight(err)
                    self._snap = self._snapshot()
                continue
            self._snap = self._snapshot()
            with self._lock:
                events = [self._events.pop(r.req_id) for r in finished
                          if r.req_id in self._events]
            for ev in events:
                ev.set()


def _pctls(samples: List[float], *ps: float) -> List[float]:
    ordered = sorted(samples)
    return [pctl(ordered, p) for p in ps]
