"""Health-checked replica pool with byte-identical stream failover: the
port of ``repro/serving/replica.py``.

N independent ``SchedulerService`` replicas share ONE engine (one copy of
the weights on the card; each scheduler owns its own pooled decode state)
behind a pool that duck-types the service interface, so
``GenerationService`` and the admission plane in front of it need no
special cases — the ``AdmissionController`` keeps doing global load
shedding while the pool does drain-aware least-loaded routing across
per-replica bounded queues.  Every replica's driver thread launches its
kernels on the same device.

Replica lifecycle: ``warming → ready → degraded → cordoned →
restarting``, driven by a health monitor thread that scores each replica
lock-free (a stalled driver HOLDS its service lock, so the monitor never
takes it): heartbeat on decode-tick progress, consecutive driver-error
counting, and last-tick latency.  A replica past the kill threshold is
cordoned, its in-flight requests are **evacuated**, its service is
abandoned (flag-flip close — see ``SchedulerService.abandon``), and a
background thread builds a fresh service in its place.

Failover is byte-identical by construction: the resubmission carries the
failed request's output-so-far (``resume_output`` — admission re-prefills
prompt+output exactly like recompute-resume preemption) and its ORIGINAL
rng key (``rng_key``), and the sampling contract draws token j from
``fold_in(key, j)`` regardless of replica, slot, or resume point — so the
continuation emits the exact tokens the failed replica would have (on the
CPU bit for bit; on the card a re-prefilled K/V is not bitwise the
decode-time K/V in bf16, so a resumed stream can part at a near-tie).
Unary requests ride the same path (their collector sink only fires on
the final terminal), giving transparent bounded, deadline-aware retry.

All resubmissions run on ONE pool failover thread, never on a scheduler
driver thread: a driver delivering a failure holds its own service lock,
and submitting to a sibling replica from there could deadlock two
drivers failing over into each other.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import (Any, Callable, Dict, FrozenSet, List, Mapping,
                    Optional, Sequence, Set)

from repro_torch.core.engine import GenerationResult, InferenceEngine
from repro_torch.core.faults import FaultInjector
from repro_torch.core.sampling import SamplingParams
from repro_torch.core.scheduler import (ZERO_PAGER_STATS,
                                        ZERO_SPECULATION_STATS, Request,
                                        SchedulerBusy, SchedulerService,
                                        TokenSink)
from repro_torch.core.telemetry import Histogram

__all__ = ["ReplicaPool", "Replica", "ZERO_REPLICA_STATS",
           "WARMING", "READY", "DEGRADED", "CORDONED", "RESTARTING"]

WARMING = "warming"
READY = "ready"
DEGRADED = "degraded"
CORDONED = "cordoned"
RESTARTING = "restarting"

# schema-stable zero block for the /metrics "replicas" section when the
# pool is not enabled (single-service mode reports its one implicit
# replica through GenerationService.replica_summary)
ZERO_REPLICA_STATS: Mapping[str, Any] = {
    "enabled": False, "count": 0, "ready": 0, "warming": 0, "degraded": 0,
    "cordoned": 0, "restarting": 0, "cordoned_ids": [], "restarts": 0,
    "kills": 0, "cordons": 0, "degraded_events": 0, "failovers": 0,
    "failovers_stream": 0, "failovers_unary": 0, "failover_failures": 0,
    "evacuations": 0, "per_replica": {},
}


class Replica:
    """One pool member: a service plus its monitored lifecycle state."""

    __slots__ = ("rid", "service", "state", "manual", "cordoned_reason",
                 "restarts", "last_steps", "last_progress", "installed_at")

    def __init__(self, rid: int, service: SchedulerService):
        self.rid = rid
        self.service = service
        self.state = WARMING
        self.manual = False                 # operator cordon (drain-aware)
        self.cordoned_reason: Optional[str] = None
        self.restarts = 0
        self.last_steps = service.scheduler.steps
        self.last_progress = time.monotonic()
        self.installed_at = time.time()


class _Tracked:
    """Pool-side state for one submission: which replica currently owns
    it, how many failovers it has burned, and the caller's sink.

    Lock discipline (deadlock-free by construction):

    - ``tracked.lock`` may be held while taking a service lock ONLY when
      the tracked request is not currently live on that service (initial
      submit, failover resubmit to a sibling).
    - A driver thread (holding its service lock) takes ``tracked.lock``
      in ``_on_event``; therefore pool calls that target the CURRENT
      replica (cancel/pause/resume) snapshot under ``tracked.lock``,
      release, then call the service.
    - The pool lock (``_plock``) may nest ``tracked.lock`` inside it,
      never the reverse.
    """

    __slots__ = ("pool", "prompt", "sampling", "user_sink", "ctx",
                 "on_reassign", "kind", "lock", "req", "replica",
                 "attempts", "done")

    def __init__(self, pool: "ReplicaPool", prompt: Sequence[int],
                 sampling: SamplingParams, user_sink: TokenSink,
                 ctx: Optional[Any],
                 on_reassign: Optional[Callable[[Request], None]],
                 kind: str):
        self.pool = pool
        self.prompt = list(prompt)
        self.sampling = sampling
        self.user_sink = user_sink
        self.ctx = ctx
        self.on_reassign = on_reassign
        self.kind = kind                     # "stream" | "unary"
        self.lock = threading.Lock()
        self.req: Optional[Request] = None
        self.replica: Optional[Replica] = None
        self.attempts = 0
        self.done = False

    def _on_event(self, req: Request, token: Optional[int],
                  done: bool) -> None:
        """The sink every replica sees.  Ghost events from an abandoned
        replica (its request is no longer ``self.req``) are dropped; an
        error terminal is swallowed when a failover resubmission was
        queued in its place.  Duplicate/raced token deliveries around a
        reassignment are safe downstream: stream replay dedups by token
        index and the token VALUES are byte-identical by the rng
        contract."""
        with self.lock:
            if self.done or req is not self.req:
                return
            if (done and req.finish_reason == "error"
                    and self.pool._queue_failover(self, req)):
                return
            if done:
                self.done = True
        self.user_sink(req, token, done)
        if done:
            self.pool._untrack(self)


class ReplicaPool:
    """Duck-types the ``SchedulerService`` interface over N replicas."""

    def __init__(self, engine: InferenceEngine, num_replicas: int, *,
                 num_slots: int = 4,
                 max_pending: Optional[int] = None,
                 interactive_weight: int = 4,
                 device_sampling: bool = True,
                 client_weights: Optional[Dict[str, float]] = None,
                 faults: Optional[FaultInjector] = None,
                 warm: bool = False,
                 health_interval_s: float = 0.05,
                 stall_warn_s: float = 0.5,
                 stall_kill_s: float = 2.0,
                 tick_degrade_s: float = 1.0,
                 error_threshold: int = 3,
                 max_failovers: int = 2,
                 monitor: bool = True):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self._engine = engine
        self._num_slots = num_slots
        self._interactive_weight = interactive_weight
        self._device_sampling = device_sampling
        self._client_weights = client_weights
        self.faults = faults
        self.max_pending = max_pending
        # per-replica bounded queue: the pool-level bound split across
        # members (each replica sheds independently; the pool only raises
        # SchedulerBusy when every routable replica is full)
        self._per_replica_pending = (
            None if max_pending is None
            else max(4, -(-max_pending // num_replicas)))
        self.health_interval_s = health_interval_s
        self.stall_warn_s = stall_warn_s
        self.stall_kill_s = stall_kill_s
        self.tick_degrade_s = tick_degrade_s
        self.error_threshold = max(1, error_threshold)
        self.max_failovers = max(0, max_failovers)

        self._plock = threading.Lock()
        self._closed = False
        self._retiring = False
        self._inflight: Set[_Tracked] = set()
        self._retired_steps = 0
        self.failovers_total = 0
        self.failovers_by_kind = {"stream": 0, "unary": 0}
        self.failover_failures = 0
        self.evacuations_total = 0
        self.kills_total = 0
        self.cordons_total = 0
        self.restarts_total = 0
        self.degraded_total = 0
        self.warm_s = 0.0

        built: List[Replica] = []
        try:
            for rid in range(num_replicas):
                built.append(Replica(rid, self._new_service(rid)))
        except BaseException:
            # crash-during-install: tear down the partial pool and
            # propagate — the caller's alias never points here
            for r in built:
                r.service.close()
            raise
        self.replicas = built
        if warm:
            # the engine, its kernels and the allocator's pools are
            # SHARED: warming one replica warms them all
            self.warm_s = self.replicas[0].service.warm()
        now = time.monotonic()
        for r in self.replicas:
            r.state = READY
            r.last_progress = now

        self._fo_queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._fo_thread = threading.Thread(
            target=self._failover_worker, daemon=True,
            name="flexserve-failover")
        self._fo_thread.start()
        self._stop = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        if monitor:
            self._monitor_thread = threading.Thread(
                target=self._monitor, daemon=True,
                name="flexserve-replica-monitor")
            self._monitor_thread.start()

    # -- construction ------------------------------------------------------

    def _new_service(self, rid: int) -> SchedulerService:
        if self.faults is not None:
            # "engine_install": between engine materialization and the
            # alias repoint — the crash-during-swap site
            self.faults.fire("engine_install", replica=rid)
        return SchedulerService(
            self._engine, self._num_slots,
            max_pending=self._per_replica_pending,
            interactive_weight=self._interactive_weight,
            device_sampling=self._device_sampling,
            client_weights=self._client_weights,
            faults=(self.faults.scoped(rid)
                    if self.faults is not None else None))

    # -- service interface -------------------------------------------------

    @property
    def engine(self) -> InferenceEngine:
        return self._engine

    @property
    def retiring(self) -> bool:
        return self._retiring

    def warm(self, **kwargs: Any) -> float:
        self.warm_s = self.replicas[0].service.warm(**kwargs)
        return self.warm_s

    def submit_request(self, prompt: Sequence[int], *,
                       sampling: SamplingParams,
                       sink: TokenSink,
                       ctx: Optional[Any] = None,
                       on_reassign: Optional[Callable[[Request], None]]
                       = None,
                       kind: str = "stream") -> Request:
        """Route one streaming request to the least-loaded ready replica.
        Raises ``SchedulerBusy`` only when every routable replica's queue
        is full, ``RuntimeError`` when the pool is closed or zero
        replicas are routable."""
        if self._closed or self._retiring:
            raise RuntimeError("replica pool is closed")
        self._engine.seq_buckets.bucket_for(len(prompt))
        tracked = _Tracked(self, prompt, sampling, sink, ctx,
                           on_reassign, kind)
        tried: Set[int] = set()
        last_err: Optional[BaseException] = None
        while True:
            r = self._pick(tried)
            if r is None:
                if isinstance(last_err, SchedulerBusy):
                    raise last_err
                raise last_err or SchedulerBusy("no ready replicas")
            try:
                with tracked.lock:
                    req = r.service.submit_request(
                        prompt, sampling=sampling,
                        sink=tracked._on_event, ctx=ctx)
                    tracked.req = req
                    tracked.replica = r
                    req._tracked = tracked
            except (SchedulerBusy, RuntimeError) as err:
                last_err = err
                tried.add(r.rid)
                continue
            with self._plock:
                self._inflight.add(tracked)
            return req

    def submit_and_wait(self, prompts: Sequence[Sequence[int]], *,
                        max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        sampling: Optional[SamplingParams] = None,
                        ctx: Optional[Any] = None,
                        timeout: Optional[float] = None) -> GenerationResult:
        """Pool-side reimplementation of the service's unary API: every
        prompt becomes a tracked streaming request with a collector sink,
        so unary traffic gets the SAME transparent failover as streams
        (a retry resumes from output-so-far on the original key — still
        byte-identical).  All-or-nothing like the service: a mid-list
        shed cancels what already landed."""
        if sampling is None:
            sampling = SamplingParams(max_new_tokens=max_new_tokens,
                                      eos_id=eos_id)
        for p in prompts:
            self._engine.seq_buckets.bucket_for(len(p))
        steps0 = self._total_steps()
        waiters: List[tuple] = []
        try:
            for i, p in enumerate(prompts):
                ev = threading.Event()
                box: Dict[str, Request] = {}

                def collect(req: Request, token: Optional[int], done: bool,
                            _ev: threading.Event = ev,
                            _box: Dict[str, Request] = box) -> None:
                    if done:
                        _box["req"] = req
                        _ev.set()

                req = self.submit_request(p, sampling=sampling.for_row(i),
                                          sink=collect, ctx=ctx,
                                          kind="unary")
                waiters.append((ev, box, req))
        except BaseException:
            for _, _, req in waiters:
                self.cancel(req)
            raise
        for ev, _, req in waiters:
            if not ev.wait(timeout=timeout):
                raise TimeoutError(
                    f"request {req.req_id} did not finish")
        finals = [box["req"] for _, box, _ in waiters]
        errs = [r.error for r in finals
                if r.finish_reason == "error" and r.error is not None]
        if errs:
            raise errs[0]
        return GenerationResult(
            tokens=[r.output for r in finals],
            prompt_lengths=[len(r.prompt) for r in finals],
            steps=self._total_steps() - steps0,
            finish_reasons=[r.finish_reason for r in finals])

    def cancel(self, req: Request) -> bool:
        r, cur = self._locate(req)
        if r is None or cur is None:
            return False
        return r.service.cancel(cur)

    def pause(self, req: Request) -> None:
        r, cur = self._locate(req)
        if r is not None and cur is not None:
            r.service.pause(cur)

    def resume(self, req: Request) -> bool:
        r, cur = self._locate(req)
        if r is None or cur is None:
            return False
        return r.service.resume(cur)

    def _locate(self, req: Request) -> tuple:
        """Current (replica, request) for a possibly-reassigned request.
        Snapshot-then-call: holding ``tracked.lock`` into a service call
        that targets the CURRENT replica would deadlock with its driver."""
        tracked: Optional[_Tracked] = getattr(req, "_tracked", None)
        if tracked is None:
            return None, req
        with tracked.lock:
            return tracked.replica, tracked.req

    def begin_retire(self) -> None:
        """Stop routing (and the monitor — no restarts during teardown),
        then let every live replica drain its in-flight work."""
        self._retiring = True
        self._stop.set()
        with self._plock:
            reps = list(self.replicas)
        for r in reps:
            if r.state in (READY, DEGRADED, WARMING) and r.service.alive:
                r.service.begin_retire()

    def drain(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        with self._plock:
            reps = list(self.replicas)
        for r in reps:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            ok = r.service.drain(left) and ok
        return ok

    def close(self) -> None:
        self._closed = True
        self._retiring = True
        self._stop.set()
        self._fo_queue.put(None)
        with self._plock:
            reps = list(self.replicas)
        for r in reps:
            r.service.abandon()
        for r in reps:
            r.service._thread.join(timeout=2.0)
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=1.0)
        self._fo_thread.join(timeout=1.0)

    # -- routing -----------------------------------------------------------

    def _pick(self, exclude: FrozenSet[int] = frozenset()
              ) -> Optional[Replica]:
        """Least-loaded ready replica (degraded only as a last resort);
        cordoned/restarting/warming members receive no new work."""
        with self._plock:
            for states in ((READY,), (DEGRADED,)):
                cands = [r for r in self.replicas
                         if r.rid not in exclude and r.state in states
                         and r.service.alive and not r.service.retiring]
                if cands:
                    return min(cands, key=lambda r: (
                        r.service.scheduler.active
                        + r.service.scheduler.pending, r.rid))
        return None

    def _total_steps(self) -> int:
        with self._plock:
            return self._retired_steps + sum(
                r.service.scheduler.steps for r in self.replicas)

    # -- failover ----------------------------------------------------------

    def _queue_failover(self, tracked: _Tracked, req: Request) -> bool:
        """Called under ``tracked.lock`` from a driver thread: decide
        cheaply whether this failure gets a failover attempt and hand it
        to the pool thread.  Bounded and deadline-aware."""
        if self._closed or self._retiring:
            return False
        if tracked.attempts >= self.max_failovers:
            return False
        ctx = tracked.ctx
        if ctx is not None and ctx.expired():
            return False
        self._fo_queue.put((tracked, req))
        return True

    def _failover_worker(self) -> None:
        while True:
            item = self._fo_queue.get()
            if item is None:
                return
            tracked, expect_req = item
            try:
                self._do_failover(tracked, expect_req)
            except Exception:           # noqa: BLE001 — keep the worker
                with self._plock:
                    self.failover_failures += 1

    def _do_failover(self, tracked: _Tracked,
                     expect_req: Optional[Request]) -> None:
        """Resubmit a failed/evacuated request on a healthy sibling with
        its output-so-far and ORIGINAL rng key; on exhaustion deliver the
        terminal failure the swallowed event promised."""
        tried: Set[int] = set()
        with tracked.lock:
            if tracked.done:
                return
            failed_req = tracked.req
            if failed_req is None or (expect_req is not None
                                      and failed_req is not expect_req):
                return              # already reassigned by an earlier pass
            if tracked.replica is not None:
                tried.add(tracked.replica.rid)
            from_rid = (tracked.replica.rid
                        if tracked.replica is not None else None)
            output = list(failed_req.output)
            key = failed_req.base_key
        cause = (f"{type(failed_req.error).__name__}: {failed_req.error}"
                 if failed_req.error is not None else "replica evacuated")
        trace = getattr(tracked.ctx, "trace", None)
        last_err: Optional[BaseException] = failed_req.error
        while tracked.attempts < self.max_failovers:
            ctx = tracked.ctx
            if ctx is not None and ctx.expired():
                break
            r = self._pick(tried)
            if r is None:
                break
            tracked.attempts += 1
            try:
                with tracked.lock:
                    if tracked.done:
                        return
                    new_req = r.service.submit_request(
                        tracked.prompt, sampling=tracked.sampling,
                        sink=tracked._on_event, ctx=tracked.ctx,
                        resume_output=output, rng_key=key)
                    tracked.req = new_req
                    tracked.replica = r
                    new_req._tracked = tracked
            except (SchedulerBusy, RuntimeError) as err:
                last_err = err
                tried.add(r.rid)
                continue
            with self._plock:
                self.failovers_total += 1
                self.failovers_by_kind[tracked.kind] += 1
            if trace is not None:
                trace.event("failover", from_replica=from_rid,
                            to_replica=r.rid, resumed_tokens=len(output),
                            cause=cause, attempt=tracked.attempts)
                trace.bump("failovers")
            if tracked.on_reassign is not None:
                tracked.on_reassign(new_req)
            return
        # exhausted (or nowhere to go): deliver the terminal failure
        with tracked.lock:
            if tracked.done:
                return
            tracked.done = True
        if not failed_req.done:
            # evacuation path: the stalled replica never finalized it
            failed_req.error = failed_req.error or last_err or RuntimeError(
                f"replica failover exhausted: {cause}")
            failed_req.finish_reason = "error"
            failed_req.done = True
        with self._plock:
            self.failover_failures += 1
        if trace is not None:
            trace.event("failover_exhausted", cause=cause,
                        attempts=tracked.attempts)
        tracked.user_sink(failed_req, None, True)
        self._untrack(tracked)

    def _untrack(self, tracked: _Tracked) -> None:
        with self._plock:
            self._inflight.discard(tracked)

    # -- health monitor ----------------------------------------------------

    def _monitor(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            now = time.monotonic()
            with self._plock:
                reps = list(self.replicas)
            for r in reps:
                if r.state in (CORDONED, RESTARTING, WARMING):
                    continue
                svc = r.service
                if (self.faults is not None and
                        self.faults.should("replica_kill",
                                           replica=r.rid) is not None):
                    self._kill(r, "injected replica kill")
                    continue
                if svc.consecutive_errors >= self.error_threshold:
                    self._kill(r, f"error storm "
                                  f"({svc.consecutive_errors} consecutive "
                                  f"driver errors)")
                    continue
                s = svc.scheduler
                busy = s.active > 0 or s.pending > 0
                steps = s.steps
                if steps != r.last_steps or not busy:
                    r.last_steps = steps
                    r.last_progress = now
                    stalled_for = 0.0
                else:
                    stalled_for = now - r.last_progress
                if busy and stalled_for >= self.stall_kill_s:
                    self._kill(r, f"decode stall "
                                  f"({stalled_for * 1e3:.0f}ms without "
                                  f"tick progress)")
                    continue
                degraded = ((busy and stalled_for >= self.stall_warn_s)
                            or svc.last_tick_s >= self.tick_degrade_s)
                with self._plock:
                    if degraded and r.state == READY:
                        r.state = DEGRADED
                        self.degraded_total += 1
                    elif not degraded and r.state == DEGRADED:
                        r.state = READY

    def _kill(self, r: Replica, cause: str) -> None:
        """Auto-cordon: abandon the service (lock-free — its driver may
        be wedged holding the lock), evacuate in-flight requests onto
        siblings through the failover path, and restart in the
        background."""
        with self._plock:
            if r.state in (CORDONED, RESTARTING):
                return
            r.state = CORDONED
            r.manual = False
            r.cordoned_reason = cause
            self.kills_total += 1
            self.cordons_total += 1
            victims = [t for t in self._inflight
                       if t.replica is r and not t.done]
        old = r.service
        old.abandon()
        with self._plock:
            self._retired_steps += old.scheduler.steps
            self.evacuations_total += len(victims)
        for t in victims:
            # expect_req=None: the failover worker snapshots the current
            # request itself (the stalled driver never finalized it)
            self._fo_queue.put((t, None))
        if not self._closed and not self._retiring:
            threading.Thread(
                target=self._restart, args=(r, old), daemon=True,
                name=f"flexserve-replica-restart-{r.rid}").start()

    def _restart(self, r: Replica, old: SchedulerService) -> None:
        old._thread.join(timeout=1.0)
        with self._plock:
            if self._closed or self._retiring or r.state != CORDONED:
                return
            r.state = RESTARTING
        try:
            svc = self._new_service(r.rid)
        except BaseException as err:    # noqa: BLE001 — stay cordoned
            with self._plock:
                r.state = CORDONED
                r.cordoned_reason = (f"restart failed: "
                                     f"{type(err).__name__}: {err}")
            return
        with self._plock:
            if self._closed:
                pass                    # close() already swept; fall through
            r.service = svc
            r.last_steps = svc.scheduler.steps
            r.last_progress = time.monotonic()
            r.restarts += 1
            r.cordoned_reason = None
            r.state = READY
            self.restarts_total += 1
        if self._closed:
            svc.close()

    # -- operator controls -------------------------------------------------

    def _replica(self, rid: int) -> Replica:
        for r in self.replicas:
            if r.rid == rid:
                return r
        raise KeyError(f"no replica {rid}")

    def cordon(self, rid: int, *, reason: str = "manual cordon"
               ) -> Dict[str, Any]:
        """Operator cordon: drain-aware — the replica takes no NEW work
        but its in-flight requests finish in place (no evacuation)."""
        r = self._replica(rid)
        with self._plock:
            if r.state != CORDONED:
                self.cordons_total += 1
            r.state = CORDONED
            r.manual = True
            r.cordoned_reason = reason
        return self.describe(r)

    def uncordon(self, rid: int) -> Dict[str, Any]:
        r = self._replica(rid)
        restart_needed = False
        with self._plock:
            if r.state == CORDONED:
                if r.service.alive and not r.service._closed:
                    r.state = READY
                    r.manual = False
                    r.cordoned_reason = None
                    r.last_steps = r.service.scheduler.steps
                    r.last_progress = time.monotonic()
                else:
                    r.manual = False
                    restart_needed = True
        if restart_needed:
            self._restart(r, r.service)
        return self.describe(r)

    # -- introspection -----------------------------------------------------

    def describe(self, r: Replica) -> Dict[str, Any]:
        """Lock-free per-replica snapshot (safe against a wedged driver)."""
        svc = r.service
        s = svc.scheduler
        return {
            "id": r.rid,
            "state": r.state,
            "manual": r.manual,
            "cordoned_reason": r.cordoned_reason,
            "restarts": r.restarts,
            "steps": s.steps,
            "active": s.active,
            "pending": s.pending,
            "driver_errors": svc.driver_errors,
            "consecutive_errors": svc.consecutive_errors,
            "last_tick_ms": svc.last_tick_s * 1e3,
            "alive": svc.alive,
        }

    def summary(self) -> Dict[str, Any]:
        with self._plock:
            reps = list(self.replicas)
            failovers = self.failovers_total
            by_kind = dict(self.failovers_by_kind)
            failures = self.failover_failures
            evac = self.evacuations_total
            kills = self.kills_total
            cordons = self.cordons_total
            restarts = self.restarts_total
            degraded = self.degraded_total
        states = [r.state for r in reps]
        return {
            "enabled": True,
            "count": len(reps),
            "ready": states.count(READY),
            "warming": states.count(WARMING),
            "degraded": states.count(DEGRADED),
            "cordoned": states.count(CORDONED),
            "restarting": states.count(RESTARTING),
            "cordoned_ids": [r.rid for r in reps if r.state == CORDONED],
            "restarts": restarts,
            "kills": kills,
            "cordons": cordons,
            "degraded_events": degraded,
            "failovers": failovers,
            "failovers_stream": by_kind.get("stream", 0),
            "failovers_unary": by_kind.get("unary", 0),
            "failover_failures": failures,
            "evacuations": evac,
            "per_replica": {str(r.rid): self.describe(r) for r in reps},
        }

    # summable scheduler-stat keys for the aggregated view
    _SUM_KEYS = ("steps", "active_slots", "pending", "parked", "pauses",
                 "num_slots", "completed", "cancelled", "deadline_missed")
    _DECODE_SUM_KEYS = (
        "ticks", "transfer_bytes_total", "prefill_transfer_bytes_total",
        "prefill_forwards", "prefill_requests", "prefill_s_total",
        "device_ms_total", "host_ms_total", "decode_tokens_total",
        "prefill_tokens_total")

    def stats(self) -> Dict[str, Any]:
        """Scheduler-schema stats aggregated across replicas (lifetime
        counters summed; latency percentiles/histograms are the first
        routable replica's — representative, not merged), plus the pool's
        own ``replicas`` section.  Never blocks on a wedged driver."""
        with self._plock:
            reps = list(self.replicas)
        snaps = []
        for r in reps:
            if r.state in (READY, DEGRADED):
                st = r.service.stats(lock_timeout=0.1)
                if st is not None:
                    snaps.append(st)
        if not snaps:
            for r in reps:
                st = r.service.stats(lock_timeout=0.25)
                if st is not None:
                    snaps.append(st)
                    break
        base = copy.deepcopy(snaps[0]) if snaps else _zero_service_stats()
        for extra in snaps[1:]:
            for k in self._SUM_KEYS:
                base[k] = base.get(k, 0) + extra.get(k, 0)
            base["pending_high_water"] = max(
                base.get("pending_high_water", 0),
                extra.get("pending_high_water", 0))
            bd, ed = base.get("decode", {}), extra.get("decode", {})
            for k in self._DECODE_SUM_KEYS:
                bd[k] = bd.get(k, 0) + ed.get(k, 0)
        base["max_pending"] = self.max_pending
        base["replicas"] = self.summary()
        return base


def _zero_service_stats() -> Dict[str, Any]:
    """SchedulerService.stats() schema with zero traffic — the fallback
    when every replica's driver is wedged mid-stall."""
    snap = Histogram().snapshot
    decode = {
        "device_sampling": True, "ticks": 0,
        "host_ms_p50": 0.0, "host_ms_p95": 0.0,
        "device_ms_p50": 0.0, "device_ms_p95": 0.0,
        "prefill_ms_p50": 0.0, "transfer_bytes_per_tick_p50": 0.0,
        "transfer_bytes_total": 0, "prefill_transfer_bytes_total": 0,
        "prefill_forwards": 0, "prefill_requests": 0,
        "prefill_s_total": 0.0, "device_ms_total": 0.0,
        "host_ms_total": 0.0, "decode_tokens_total": 0,
        "prefill_tokens_total": 0, "compiled_steps": 0,
        "host_ms_hist": snap(), "device_ms_hist": snap(),
        "prefill_ms_hist": snap(), "transfer_bytes_hist": snap(),
    }
    return {
        "decode": decode,
        "pager": dict(ZERO_PAGER_STATS),
        "speculation": dict(ZERO_SPECULATION_STATS),
        "steps": 0, "active_slots": 0, "pending": 0,
        "pending_high_water": 0, "max_pending": None, "parked": 0,
        "pauses": 0, "num_slots": 0, "completed": 0, "cancelled": 0,
        "deadline_missed": 0,
        "request_latency_p50_ms": 0.0, "request_latency_p95_ms": 0.0,
        "ttft_p50_ms": 0.0, "ttft_p95_ms": 0.0,
        "inter_token_p50_ms": 0.0, "inter_token_p95_ms": 0.0,
        "request_latency_ms_hist": snap(), "ttft_ms_hist": snap(),
        "inter_token_ms_hist": snap(), "queue_wait_ms_hist": snap(),
    }
