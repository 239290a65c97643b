"""Streaming generation subsystem: the request-lifecycle layer between the
REST front-end and the continuous-batching scheduler.  The port of
``repro/serving/generate.py``.

``GenerationService`` owns everything that happens to a generate request
after the HTTP handler has parsed it:

  * **Token streaming** — ``stream()`` admits one prompt into a decode
    slot and returns a ``GenerationStream`` whose ``events()`` iterator
    yields one JSON-able event per decoded token as it lands (the HTTP
    layer writes each as one chunk), closing with an end-of-stream summary
    (token count, finish reason, TTFT, total latency).  Non-streaming
    ``generate()`` keeps the blocking all-at-once path.

  * **Per-request sampling** — every request carries its own
    ``SamplingParams``; slots sharing a decode batch sample independently
    ON DEVICE through the decode-and-sample call (``core/sampling.py``):
    per tick only the sampled token ids cross to host, and the first
    token comes from the scheduler's BATCHED bucketed prefill (queued
    same-signature admissions share one forward).  Per-scheduler decode
    breakdown (host/device ms, transfer bytes, prefill batching) is on
    ``stats()`` under ``"decode"``.

  * **Versioned engines** — the service maps version ALIASES ("stable",
    "canary", ...) to engine entries, mirroring the lifecycle manager's
    ensemble aliases.  ``install()`` hot-swaps an alias to a new engine:
    new requests land on the new engine's scheduler immediately, in-flight
    streams DRAIN on the old engine (nothing is truncated), and only then
    is the old scheduler closed.  The ``ModelManager`` drives this from
    store-backed versions (load_engine / rollback_engine).

  * **Cancellation** — a client that disconnects mid-stream has its
    request cancelled and its decode slot freed at the next scheduler
    tick; cancellations, TTFT, and inter-token latency are all on
    /metrics.

  * **Backpressure** — each stream's event queue is BOUNDED.  When a
    stalled consumer lets it fill, the stream's decode slot is PAUSED
    (preempted — the slot goes to other traffic) instead of buffering
    tokens unboundedly; when the consumer drains the queue, the missed
    tokens are replayed from the request's output record and the request
    resumes via recompute (re-prefill of prompt + output so far).  A
    consumer that never returns is handled by the existing
    disconnect-cancellation path, which frees the parked request too.

The token sinks run on each scheduler's driver thread and only ever
enqueue (never block) into per-stream queues — a slow or dead client
never stalls decoding for the other slots.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

from repro_torch.core.engine import GenerationResult, InferenceEngine
from repro_torch.core.faults import FaultInjector
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.scheduler import (ZERO_PAGER_STATS,
                                        ZERO_SPECULATION_STATS, Request,
                                        SchedulerBusy, SchedulerService)
from repro_torch.core.telemetry import BYTES_BUCKETS, Histogram
from repro_torch.serving.admission import RequestContext, ShedError
from repro_torch.serving.replica import (CORDONED, READY, ReplicaPool,
                                         ZERO_REPLICA_STATS)

# HTTP status a finished stream's trace records, by finish reason
_TRACE_STATUS = {"deadline": 504, "error": 500, "cancelled": 499}


class GenerationError(RuntimeError):
    """Generation-plane failure (no engine, unknown alias)."""


class _EngineEntry:
    """One versioned engine serving one alias: its own scheduler service
    (or a ``ReplicaPool`` duck-typing it)."""

    __slots__ = ("name", "version", "service", "installed_at")

    def __init__(self, name: str, version: int, service: SchedulerService):
        self.name = name
        self.version = version
        self.service = service
        self.installed_at = time.time()

    @property
    def label(self) -> str:
        return f"{self.name}@v{self.version}"


class _BoundedEvents:
    """Per-stream event transport with a hard bound.  Token puts FAIL when
    full (the sink then pauses the slot — backpressure, not buffering);
    terminal puts always land so a stream can always be closed out."""

    class Empty(Exception):
        pass

    def __init__(self, bound: int):
        self._dq: collections.deque = collections.deque()
        self._bound = max(1, bound)
        self._cond = threading.Condition()
        self.high_water = 0

    def put(self, ev: Optional[Dict[str, Any]], *,
            force: bool = False) -> bool:
        with self._cond:
            if not force and len(self._dq) >= self._bound:
                return False
            self._dq.append(ev)
            self.high_water = max(self.high_water, len(self._dq))
            self._cond.notify()
            return True

    def get(self, timeout: float) -> Optional[Dict[str, Any]]:
        with self._cond:
            if not self._dq:
                self._cond.wait(timeout)
            if not self._dq:
                raise self.Empty
            return self._dq.popleft()

    def depth(self) -> int:
        with self._cond:
            return len(self._dq)


class GenerationStream:
    """Handle on one in-flight streaming request.

    ``events()`` yields dict events in order:
        {"event": "token", "token": t, "index": i}          (per token)
        {"event": "done", "tokens": [...], "finish_reason": ...,
         "token_count": n, "prompt_length": ..., "ttft_ms": ...,
         "total_ms": ..., "engine": "name@vN"}              (terminal)
    or a terminal {"event": "error", "error": ...} if the engine failed.
    ``cancel()`` abandons the request and frees its decode slot.

    The event queue holds at most ``max_buffered`` token events.  A
    consumer that stalls past that pauses the request's decode slot (the
    sink never blocks and never buffers more); when the consumer comes
    back, ``events()`` replays anything it missed straight from the
    request's output record and resumes the request.
    """

    def __init__(self, service: "GenerationService", entry: _EngineEntry,
                 sampling: SamplingParams, *,
                 ctx: Optional[RequestContext] = None,
                 max_buffered: int = 32,
                 on_finish: Optional[Callable[[], Any]] = None):
        self._service = service
        self._entry = entry
        self._sampling = sampling
        self.ctx = ctx
        self._queue = _BoundedEvents(max_buffered)
        self._on_finish = on_finish
        self._finish_lock = threading.Lock()
        self.request: Optional[Request] = None        # set right after submit

    # --- sink: runs on the scheduler driver thread; must never block ---------

    def _sink(self, req: Request, token: Optional[int], done: bool) -> None:
        tr = req.trace
        if token is not None:
            ev = {"event": "token", "token": token,
                  "index": len(req.output) - 1}
            ok = self._queue.put(ev)
            if tr is not None:
                tr.bump("stream_events")
            if not ok and self._entry.service.retiring:
                # engine swap draining: backpressure yields to the
                # zero-truncation guarantee — growth is bounded by the
                # request's remaining token budget
                self._queue.put(ev, force=True)
                if tr is not None:
                    tr.bump("swap_drain_forced")
            elif not ok and not done:
                # consumer stalled: preempt the slot rather than buffer.
                # The dropped token stays in req.output and is replayed by
                # events() before the resume.  Setting the flag directly is
                # safe — the sink runs ON the driver thread.
                req.paused = True
                if tr is not None:
                    tr.bump("stream_stalls")
                self._service._stream_paused()
        if done:
            self._queue.put(self._terminal_event(req), force=True)
            self._queue.put(None, force=True)         # end-of-stream marker
            self._finish_once()
            self._service._finished(req)

    def _finish_once(self) -> None:
        # a disconnect (handler thread) can race the terminal sink event
        # (driver thread); the swap under a lock guarantees one caller
        with self._finish_lock:
            cb, self._on_finish = self._on_finish, None
        if cb is not None:
            cb()
        # a STREAM's trace is sealed here, not by the HTTP route (which
        # returns before the stream body finishes).  Trace.finish is
        # idempotent, so the disconnect/terminal race records one outcome.
        req = self.request
        if req is not None and req.done:
            tr = req.trace
            if tr is not None:
                tr.finish(
                    status=_TRACE_STATUS.get(req.finish_reason, 200),
                    finish_reason=req.finish_reason,
                    error=(f"{type(req.error).__name__}: {req.error}"
                           if req.error is not None else None))

    def _terminal_event(self, req: Request) -> Dict[str, Any]:
        if req.finish_reason == "error":
            return {"event": "error",
                    "error": f"{type(req.error).__name__}: {req.error}"
                             if req.error is not None else "engine failure"}
        ev = {"event": "done", "tokens": list(req.output),
              "finish_reason": req.finish_reason,
              "token_count": len(req.output),
              "prompt_length": len(req.prompt),
              "total_ms": 1e3 * (req.latency_s or 0.0),
              "engine": self._entry.label,
              "sampling": self._sampling.describe(),
              # speculative-decoding acceptance summary: zeros when the
              # serving engine is non-speculative or the request opted out
              "speculation": {
                  "proposed": req.spec_proposed,
                  "accepted": req.spec_accepted,
                  "acceptance_rate": (req.spec_accepted / req.spec_proposed
                                      if req.spec_proposed else 0.0)}}
        if req.ttft_s is not None:
            ev["ttft_ms"] = 1e3 * req.ttft_s
        if req.pause_count:
            ev["pauses"] = req.pause_count
        if self.ctx is not None and self.ctx.trace_id:
            ev["trace_id"] = self.ctx.trace_id
        return ev

    # --- consumer side --------------------------------------------------------

    _POLL_S = 0.02

    def events(self, timeout: Optional[float] = 120.0
               ) -> Iterator[Dict[str, Any]]:
        """Yield events until the terminal one (inclusive).  ``timeout``
        bounds the wait for EACH event, not the whole stream.  Tokens the
        bounded queue dropped during a pause are replayed (in order, by
        index) from the request's output record before the request is
        resumed, so the consumer sees every token exactly once."""
        next_idx = 0
        waited = 0.0
        while True:
            poll = (self._POLL_S if timeout is None
                    else min(self._POLL_S, max(timeout - waited, 0.001)))
            t0 = time.perf_counter()
            try:
                ev = self._queue.get(timeout=poll)
            except _BoundedEvents.Empty:
                req = self.request
                if (req is not None and req.paused and not req.done):
                    # stalled consumer came back: hand it what the queue
                    # dropped (req.output only ever grows; the slice is
                    # safe to read), then put the request back to work
                    for j in range(next_idx, len(req.output)):
                        yield {"event": "token", "token": req.output[j],
                               "index": j, "replayed": True}
                        next_idx = j + 1
                    self._entry.service.resume(req)
                    waited = 0.0
                    continue
                waited += time.perf_counter() - t0
                if timeout is not None and waited >= timeout:
                    self.cancel()
                    yield {"event": "error",
                           "error": f"no token within {timeout}s"}
                    return
                continue
            waited = 0.0
            if ev is None:
                return
            if ev.get("event") == "token":
                idx = ev["index"]
                if idx < next_idx:
                    continue              # duplicate of a replayed token
                while next_idx < idx:     # gap: dropped while queue full
                    yield {"event": "token",
                           "token": self.request.output[next_idx],
                           "index": next_idx, "replayed": True}
                    next_idx += 1
                next_idx = idx + 1
                yield ev
            else:
                if ev.get("event") == "done":
                    toks = ev.get("tokens") or []
                    while next_idx < len(toks):   # gap before the terminal
                        yield {"event": "token", "token": toks[next_idx],
                               "index": next_idx, "replayed": True}
                        next_idx += 1
                yield ev

    def queue_depth(self) -> int:
        return self._queue.depth()

    @property
    def queue_high_water(self) -> int:
        return self._queue.high_water

    def _reassign(self, new_req: Request) -> None:
        """Replica failover moved the request: subsequent replay/resume/
        cancel must target the NEW request.  Safe to swap mid-iteration —
        the new request's output starts as a superset snapshot of the old
        one's, so index-based replay stays monotonic."""
        self.request = new_req

    def cancel(self) -> bool:
        """Abandon the stream (client went away); frees the decode slot —
        including a slot-less parked (paused) request."""
        self._finish_once()
        if self.request is None:
            return False
        return self._entry.service.cancel(self.request)


class GenerationService:
    """Versioned, streaming generate front-end (see module docstring).

    Constructed either around a static ``engine`` (installed as
    ``engine@v0`` under the default alias) or empty, with engines
    installed later by the lifecycle manager.
    """

    def __init__(self, engine: Optional[InferenceEngine] = None, *,
                 num_slots: int = 4, default_alias: str = "stable",
                 drain_timeout_s: float = 30.0,
                 max_pending: Optional[int] = None,
                 max_stream_buffer: int = 32,
                 client_weights: Optional[Dict[str, float]] = None,
                 num_replicas: int = 1,
                 faults: Optional[FaultInjector] = None,
                 replica_options: Optional[Dict[str, Any]] = None):
        self.num_slots = num_slots
        self.default_alias = default_alias
        self.drain_timeout_s = drain_timeout_s
        # per-client weighted fair dequeue inside every engine's scheduler
        self.client_weights = client_weights
        # replica pool: with num_replicas > 1 every installed engine fans
        # out into N health-checked SchedulerService replicas behind one
        # entry (engine swaps swap the whole pool); replica_options tunes
        # the pool's health monitor / failover knobs
        self.num_replicas = max(1, num_replicas)
        self.faults = faults
        self.replica_options = dict(replica_options or {})
        # backstop bound on each engine's pending deque; the app-level
        # AdmissionController sheds earlier (and with better hints), this
        # keeps a directly-driven service bounded too
        self.max_pending = (max_pending if max_pending is not None
                            else max(32, 8 * num_slots))
        self.max_stream_buffer = max_stream_buffer
        self._lock = threading.Lock()
        self._aliases: Dict[str, _EngineEntry] = {}
        self._stats_lock = threading.Lock()
        self._streams = {"started": 0, "completed": 0, "cancelled": 0,
                         "failed": 0, "deadline": 0, "paused": 0}
        self._swaps = 0
        self._closed = False
        if engine is not None:
            self.install("engine", 0, engine)

    # --- engine lifecycle -----------------------------------------------------

    def install(self, name: str, version: int, engine: InferenceEngine, *,
                alias: Optional[str] = None,
                num_slots: Optional[int] = None,
                warm: bool = False) -> Dict[str, Any]:
        """Serve ``engine`` as ``name@vversion`` under ``alias``.

        The swap is atomic for admission: requests submitted after this
        returns (and any racing submit that wins the pointer swap) land on
        the NEW engine.  Requests already admitted keep decoding on the
        old engine until they finish — the old scheduler is drained, then
        closed, so no in-flight stream is truncated by a swap.  ``warm``
        runs the decode data path once (prefill buckets, sampler, decode
        tick) BEFORE the alias flips, so the first live streams never pay
        for kernel builds or the allocator's growth.

        With ``num_replicas > 1`` the engine fans out into a full
        :class:`ReplicaPool` (one scheduler per replica over the SHARED
        engine).  A failure while building the pool — e.g. an injected
        ``engine_install`` fault — tears the partial pool down and
        propagates BEFORE the alias flips, so no request ever observes a
        half-installed version."""
        if self.num_replicas > 1:
            service = ReplicaPool(engine, self.num_replicas,
                                  num_slots=num_slots or self.num_slots,
                                  max_pending=self.max_pending,
                                  client_weights=self.client_weights,
                                  faults=self.faults, warm=warm,
                                  **self.replica_options)
            warm_s = service.warm_s
        else:
            service = SchedulerService(
                engine, num_slots=num_slots or self.num_slots,
                max_pending=self.max_pending,
                client_weights=self.client_weights,
                faults=self.faults)
            warm_s = service.warm() if warm else 0.0
        entry = _EngineEntry(name, version, service)
        with self._lock:
            if self._closed:
                service.close()
                raise GenerationError("generation service is closed")
            alias = alias or self.default_alias
            old = self._aliases.get(alias)
            self._aliases[alias] = entry
            # alias re-pointing (promote/demote) lets several aliases
            # share one entry: only retire the displaced entry once no
            # alias references it anymore
            still = any(e is old for e in self._aliases.values())
        drained, drain_s = True, 0.0
        if old is not None and not still:
            drained, drain_s = self._retire(old)
        with self._stats_lock:
            self._swaps += 1
        return {"alias": alias, "engine": entry.label,
                "previous_engine": old.label if old is not None else None,
                "drained": drained, "drain_ms": 1e3 * drain_s,
                "warm_ms": 1e3 * warm_s}

    def _retire(self, old: _EngineEntry) -> "tuple[bool, float]":
        # refuse-new FIRST: a submit racing the swap either landed
        # before this (drain waits for it) or raises and is retried
        # on the alias's new entry — no stream is ever stranded in a
        # closing scheduler
        old.service.begin_retire()
        t0 = time.perf_counter()
        drained = old.service.drain(self.drain_timeout_s)
        drain_s = time.perf_counter() - t0
        old.service.close()
        return drained, drain_s

    def repoint(self, from_alias: str, to_alias: str) -> Dict[str, Any]:
        """Point ``to_alias`` at ``from_alias``'s engine entry — the
        canary-promotion primitive (``repoint("canary", "stable")`` makes
        the canary's engine the stable one with NO reload and NO warmup:
        both aliases share the live entry, scheduler and all).  The entry
        ``to_alias`` displaced drains and closes only if no other alias
        still references it.  Demotion is the same call reversed."""
        with self._lock:
            if self._closed:
                raise GenerationError("generation service is closed")
            try:
                src = self._aliases[from_alias]
            except KeyError:
                raise GenerationError(
                    f"no generation engine under alias {from_alias!r}; "
                    f"available: {sorted(self._aliases)}") from None
            old = self._aliases.get(to_alias)
            if old is src:
                return {"alias": to_alias, "engine": src.label,
                        "previous_engine": src.label, "changed": False}
            self._aliases[to_alias] = src
            still = any(e is old for e in self._aliases.values())
        drained, drain_s = True, 0.0
        if old is not None and not still:
            drained, drain_s = self._retire(old)
        with self._stats_lock:
            self._swaps += 1
        return {"alias": to_alias, "engine": src.label,
                "previous_engine": old.label if old is not None else None,
                "changed": True, "drained": drained,
                "drain_ms": 1e3 * drain_s}

    @property
    def ready(self) -> bool:
        with self._lock:
            return self.default_alias in self._aliases

    def aliases(self) -> List[str]:
        with self._lock:
            return sorted(self._aliases)

    def entry_for(self, alias: Optional[str] = None) -> _EngineEntry:
        alias = alias or self.default_alias
        with self._lock:
            try:
                return self._aliases[alias]
            except KeyError:
                raise GenerationError(
                    f"no generation engine under alias {alias!r}; "
                    f"available: {sorted(self._aliases)}") from None

    def engine_for(self, alias: Optional[str] = None) -> InferenceEngine:
        return self.entry_for(alias).service.engine

    # --- request lifecycle ----------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingParams] = None, *,
                 alias: Optional[str] = None,
                 ctx: Optional[RequestContext] = None,
                 timeout: Optional[float] = None) -> GenerationResult:
        """Blocking all-at-once generation (the legacy response shape).
        ``ctx`` carries priority + deadline into the scheduler's pending
        deques; a full deque surfaces as ShedError (429 upstream)."""
        sampling = sampling or SamplingParams()
        while True:
            entry = self.entry_for(alias)
            self._annotate_version(ctx, entry, alias)
            try:
                return entry.service.submit_and_wait(
                    prompts, sampling=sampling, ctx=ctx, timeout=timeout)
            except GenerationError:
                raise
            except SchedulerBusy as e:
                raise ShedError(str(e)) from None
            except RuntimeError:
                # raced an engine swap into the retiring old service: the
                # alias already points at the replacement — retry there.
                # Each retry requires ANOTHER swap to have moved the
                # pointer, so this terminates; an unmoved pointer means a
                # real failure
                if entry is self.entry_for(alias):
                    raise

    def stream(self, prompt: Sequence[int],
               sampling: Optional[SamplingParams] = None, *,
               alias: Optional[str] = None,
               ctx: Optional[RequestContext] = None,
               max_buffered: Optional[int] = None,
               on_finish: Optional[Callable[[], Any]] = None
               ) -> GenerationStream:
        """Admit one prompt and return the stream handle immediately;
        tokens arrive on the handle as the scheduler decodes them.
        ``max_buffered`` bounds the stream's event queue (backpressure —
        see GenerationStream); ``on_finish`` runs exactly once when the
        stream reaches a terminal event or is cancelled."""
        sampling = sampling or SamplingParams()
        while True:
            entry = self.entry_for(alias)
            self._annotate_version(ctx, entry, alias)
            stream = GenerationStream(
                self, entry, sampling, ctx=ctx,
                max_buffered=max_buffered or self.max_stream_buffer,
                on_finish=on_finish)
            try:
                stream.request = entry.service.submit_request(
                    prompt, sampling=sampling, sink=stream._sink, ctx=ctx,
                    on_reassign=stream._reassign)
                break
            except GenerationError:
                raise
            except SchedulerBusy as e:
                stream._finish_once()
                raise ShedError(str(e)) from None
            except RuntimeError:
                # raced an engine swap into the retiring old service: the
                # alias already points at the replacement — admit there.
                # Terminates because each retry needs another swap to have
                # moved the pointer; an unmoved pointer is a real failure
                if entry is self.entry_for(alias):
                    raise
        with self._stats_lock:
            self._streams["started"] += 1
        return stream

    def _annotate_version(self, ctx: Optional[RequestContext],
                          entry: _EngineEntry,
                          alias: Optional[str]) -> None:
        """Stamp the serving engine's identity on the request trace so
        the SLI/usage aggregators can attribute it per version (and the
        SLO controller can evaluate the alias's traffic)."""
        tr = getattr(ctx, "trace", None)
        if tr is not None and hasattr(tr, "annotate"):
            tr.annotate("version", entry.label)
            tr.annotate("alias", alias or self.default_alias)

    def _finished(self, req: Request) -> None:
        key = ("cancelled" if req.finish_reason == "cancelled" else
               "failed" if req.finish_reason == "error" else
               "deadline" if req.finish_reason == "deadline" else
               "completed")
        with self._stats_lock:
            self._streams[key] += 1

    def _stream_paused(self) -> None:
        with self._stats_lock:
            self._streams["paused"] += 1

    # --- observability / teardown ---------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            entries = dict(self._aliases)
        engines = {a: {"engine": e.label, **e.service.stats()}
                   for a, e in entries.items()}
        with self._stats_lock:
            out: Dict[str, Any] = {"streams": dict(self._streams),
                                   "engine_swaps": self._swaps}
        # the default alias's scheduler stats at top level keep the
        # /metrics "generate" section shape stable for dashboards — zeroed
        # before the first engine load so scrapers never hit missing keys
        zero_ms = Histogram().snapshot()
        zero_bytes = Histogram(BYTES_BUCKETS).snapshot()
        out.update({"steps": 0, "active_slots": 0, "pending": 0,
                    "pending_high_water": 0,
                    "max_pending": self.max_pending,
                    "parked": 0, "pauses": 0,
                    "num_slots": self.num_slots, "completed": 0,
                    "cancelled": 0, "deadline_missed": 0,
                    "request_latency_p50_ms": 0.0,
                    "request_latency_p95_ms": 0.0,
                    "ttft_p50_ms": 0.0, "ttft_p95_ms": 0.0,
                    "inter_token_p50_ms": 0.0, "inter_token_p95_ms": 0.0,
                    "request_latency_ms_hist": zero_ms,
                    "ttft_ms_hist": zero_ms,
                    "inter_token_ms_hist": zero_ms,
                    "queue_wait_ms_hist": zero_ms,
                    "decode": {"device_sampling": True, "ticks": 0,
                               "host_ms_p50": 0.0, "host_ms_p95": 0.0,
                               "device_ms_p50": 0.0, "device_ms_p95": 0.0,
                               "prefill_ms_p50": 0.0,
                               "transfer_bytes_per_tick_p50": 0,
                               "transfer_bytes_total": 0,
                               "prefill_transfer_bytes_total": 0,
                               "prefill_forwards": 0,
                               "prefill_requests": 0,
                               "prefill_s_total": 0.0,
                               "device_ms_total": 0.0,
                               "host_ms_total": 0.0,
                               "decode_tokens_total": 0,
                               "prefill_tokens_total": 0,
                               "compiled_steps": None,
                               "host_ms_hist": zero_ms,
                               "device_ms_hist": zero_ms,
                               "prefill_ms_hist": zero_ms,
                               "transfer_bytes_hist": zero_bytes},
                    # paged-KV engines overwrite the zeroed KVPager schema
                    # (page utilization, prefix hit rate, fast resumes)
                    "pager": dict(ZERO_PAGER_STATS),
                    # speculative engines overwrite the zeroed schema
                    # (acceptance EMA, window histogram, draft/verify ms)
                    "speculation": dict(ZERO_SPECULATION_STATS),
                    # replica pools overwrite the zeroed pool schema
                    # (lifecycle states, failovers, restarts)
                    "replicas": dict(ZERO_REPLICA_STATS)})
        default = engines.get(self.default_alias)
        if default is not None:
            out.update({k: v for k, v in default.items() if k != "engine"})
        out["engines"] = engines
        return out

    # --- replica pool surface ---------------------------------------------------

    def pool_for(self, alias: Optional[str] = None
                 ) -> Optional[ReplicaPool]:
        """The alias's replica pool, or ``None`` in single-service mode
        (or before any engine is installed)."""
        try:
            entry = self.entry_for(alias)
        except GenerationError:
            return None
        return entry.service if isinstance(entry.service, ReplicaPool) \
            else None

    def replica_summary(self, alias: Optional[str] = None
                        ) -> Dict[str, Any]:
        """Pool health summary for /healthz and /v1/replicas.  In
        single-service mode the one implicit replica is reported (ready
        iff its driver thread is alive), so readiness aggregation works
        either way."""
        try:
            entry = self.entry_for(alias)
        except GenerationError:
            return dict(ZERO_REPLICA_STATS)
        svc = entry.service
        if isinstance(svc, ReplicaPool):
            return svc.summary()
        out = dict(ZERO_REPLICA_STATS)
        alive = bool(getattr(svc, "alive", True))
        out.update({
            "count": 1,
            "ready": 1 if alive else 0,
            "per_replica": {"0": {
                "id": 0, "state": READY if alive else CORDONED,
                "manual": False, "cordoned_reason": None, "restarts": 0,
                "steps": svc.scheduler.steps,
                "active": svc.scheduler.active,
                "pending": svc.scheduler.pending,
                "driver_errors": svc.driver_errors,
                "consecutive_errors": svc.consecutive_errors,
                "last_tick_ms": svc.last_tick_s * 1e3,
                "alive": alive,
            }}})
        if not alive:
            out["cordoned"] = 1
            out["cordoned_ids"] = [0]
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            entries = list(self._aliases.values())
            self._aliases.clear()
        seen: set = set()
        for e in entries:              # aliases may share one entry
            if id(e) not in seen:
                seen.add(id(e))
                e.service.close()
