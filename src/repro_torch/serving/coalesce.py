"""Cross-request batch coalescing (the server-side half of paper §2.3).

The REST front-end is threaded, but the accelerator wants ONE large forward,
not N concurrent small ones.  ``BatchCoalescer`` sits between the two: HTTP
handler threads enqueue their input rows and block; a single dispatch thread
gathers every compatible request that arrives within ``max_wait_ms`` (or
until ``max_rows`` accumulate), concatenates the rows, runs ONE bucketed
ensemble forward, and scatters per-request output slices back to the waiting
threads.  This is the TF-Serving-style request coalescing that turns a model
endpoint into a throughput device: rows-per-forward grows with concurrency
while the set of shapes served stays bounded by the bucket spec.

Incompatible requests do NOT split an open group: the dispatcher keeps one
sub-queue PER SIGNATURE (array keys/trailing shapes/dtypes, plus an
optional routing ``tag``), so interleaved traffic with mixed shapes — or
mixed version-alias targets — coalesces within each signature instead of
flushing each other's half-filled groups.

Only the *forward* is shared — per-request post-processing (vote policy,
detection threshold) happens on each request's own logits slice, so requests
with different policies still coalesce into the same device batch.

Given a ``Stages`` recorder (the app's ``trace`` flag), the dispatch thread
switches through ``DISPATCH_STAGES``, which tile its time, and each forward
is marked on the device's clock (CUDA events on the current stream where
the members are on a card): ``device_forward_ms_hist`` from the mark before
the forward call to the one after it returns, ``device_gap_ms_hist`` from
the previous forward's end mark to this one's begin mark, the time the
device waits between forwards; none is recorded before a forward that
follows a whole idle poll (``IDLE_POLL_S`` with no work at all), where the
device waited for requests, not for the host.  A handler thread in
``frontend.parse`` (opened by the HTTP handler) closes it at ``submit``
and opens ``frontend.respond`` from the moment the dispatcher releases
it.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.batching import BucketSpec, to_numpy
from repro_torch.core.telemetry import Histogram, Reservoir, Stages
from repro_torch.serving.admission import DeadlineError

# the dispatch thread's stages: blocked with no open group, blocked with
# one open, the loop's bookkeeping, the group merged, the forward called
# (it returns before the device finishes), the host waiting for the logits,
# the results handed back
WAIT, LINGER, COLLECT, MERGE, LAUNCH, SYNC, SCATTER = (
    "coalesce.wait", "coalesce.linger", "coalesce.collect", "coalesce.merge",
    "coalesce.launch", "coalesce.sync", "coalesce.scatter")
DISPATCH_STAGES = (WAIT, LINGER, COLLECT, MERGE, LAUNCH, SYNC, SCATTER)
# a handler thread's: the body in hand to ``submit``, and its release by
# the dispatcher to the last byte of the answer written
PARSE, RESPOND = "frontend.parse", "frontend.respond"
FRONTEND_STAGES = (PARSE, RESPOND)
# how long the dispatcher blocks with no open group before it looks at
# ``close`` again
IDLE_POLL_S = 0.1


@dataclass
class _Pending:
    """One request's rows plus the rendezvous the handler thread waits on."""

    batch: Dict[str, np.ndarray]
    n: int
    enqueued_at: float
    tag: Optional[Hashable] = None
    ctx: Optional[Any] = None           # RequestContext (deadline/priority)
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, np.ndarray]] = None
    error: Optional[BaseException] = None
    wait_s: float = 0.0
    released_at: Optional[float] = None   # stamped with stages on

    def expired(self, now: float) -> bool:
        return self.ctx is not None and self.ctx.expired(now)

    def signature(self):
        """Requests coalesce only when every array agrees on key, trailing
        shape, and dtype — the concat along axis 0 must be well-formed —
        AND they share the routing tag (e.g. a version alias)."""
        return (self.tag,) + tuple(
            sorted((k, v.shape[1:], v.dtype.str)
                   for k, v in self.batch.items()))


class _Group:
    """An open per-signature sub-queue accumulating toward one forward."""

    __slots__ = ("entries", "rows", "deadline", "grace_at")

    def __init__(self, first: _Pending, deadline: float):
        self.entries: List[_Pending] = [first]
        self.rows = first.n
        self.deadline = deadline
        self.grace_at: Optional[float] = None


class CoalesceError(RuntimeError):
    pass


class BatchCoalescer:
    """Admission queue + single dispatch thread around a batch-polymorphic
    ``forward_fn(batch_dict) -> pytree`` (normally ``Ensemble.forward``).
    A ``forward_fn(batch_dict, tag)`` is also accepted — the tag given to
    ``submit`` is passed through, letting the server route each group
    (e.g. to a version alias's ensemble).

    Parameters
    ----------
    forward_fn:   executed on the dispatch thread only — it needs no lock.
    buckets:      the bucket spec the forward pads to; coalesced
                  groups never exceed the largest bucket.
    max_wait_ms:  how long the dispatcher lingers for more rows after the
                  first request of a group arrives (the latency knob).
                  ``None`` (the default) derives the linger ADAPTIVELY
                  from the observed request inter-arrival gap (EWMA): a
                  few gaps' worth under load — long enough for the next
                  requests to join — collapsing to near zero when traffic
                  is too sparse for lingering to ever pay.  A float pins
                  the fixed linger (the pre-adaptive behavior).
    max_rows:     hard cap on rows per forward (default: largest bucket).
    boundary_grace_ms:
                  once a group's rows exactly fill a bucket and the queue
                  is empty, wait only this long for stragglers before
                  flushing — long enough to absorb near-simultaneous
                  arrivals, short enough that a lone request barely notices.
    stages:       a ``Stages`` to record the dispatch and handler stages
                  into, and to mark each forward on the device's clock;
                  ``None`` records nothing.
    device:       returns the device the forward runs on (read per
                  forward while ``stages`` records); a CUDA device's
                  forwards are marked with CUDA events, any other's on the
                  host clock (its forward has finished when it returns).
    """

    # adaptive-linger envelope: linger ~ GAIN x EWMA inter-arrival gap,
    # clamped to [MIN, CAP]; gaps beyond the cap mean the next request
    # cannot arrive inside any permissible linger, so don't linger at all
    ADAPTIVE_MIN_S = 2e-4
    ADAPTIVE_CAP_S = 10e-3
    ADAPTIVE_GAIN = 4.0
    _EWMA_ALPHA = 0.2

    def __init__(self, forward_fn: Callable, buckets: BucketSpec, *,
                 max_wait_ms: Optional[float] = None,
                 max_rows: Optional[int] = None,
                 boundary_grace_ms: float = 1.5,
                 stages: Optional[Stages] = None,
                 device: Optional[Callable[[], Optional[torch.device]]]
                 = None):
        self._forward = forward_fn
        try:
            self._fwd_nparams = len(
                inspect.signature(forward_fn).parameters)
        except (TypeError, ValueError):   # builtins, odd callables
            self._fwd_nparams = 1
        self.buckets = buckets
        self.adaptive = max_wait_ms is None
        self.max_wait_s = (self.ADAPTIVE_CAP_S if self.adaptive
                           else max_wait_ms / 1e3)
        self.boundary_grace_s = min(boundary_grace_ms / 1e3, self.max_wait_s)
        self.max_rows = min(max_rows or buckets.sizes[-1], buckets.sizes[-1])
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._closed = False
        # Orders submit() against close(): any entry enqueued under this
        # lock precedes the close sentinel in the FIFO, so it is always
        # either executed or drained — never stranded.
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._batches = 0
        self._rows = 0
        self._max_rows_seen = 0
        # queue waits: uniform reservoir for the JSON percentiles (bounded
        # and unbiased, unlike the trimmed list it replaces) + fixed-bucket
        # histograms with slow-request exemplars for Prometheus
        self._waits = Reservoir(2048)
        self._wait_hist = Histogram()
        self._fwd_hist = Histogram()
        self._last_arrival: Optional[float] = None
        self._ewma_gap_s: Optional[float] = None
        self._pending_rows = 0          # rows enqueued but not yet forwarded
        self._pending_high = 0
        self._open_groups = 0
        self._deadline_dropped = 0
        self._ewma_fwd_s: Optional[float] = None
        self._stages = stages
        self._device_of = device
        self._clock = None                # the dispatch thread's StageClock
        self._dev_fwd_hist = Histogram()
        self._dev_gap_hist = Histogram()
        self._prev_fwd_end: Any = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="flexserve-coalescer")
        self._thread.start()

    # --- client side (HTTP handler threads) ----------------------------------

    def submit(self, batch: Dict[str, np.ndarray],
               tag: Optional[Hashable] = None,
               ctx: Optional[Any] = None):
        """Block until this request's rows have been through a forward;
        returns the output pytree sliced back to this request's rows.
        ``ctx`` (a RequestContext) tightens its group's flush deadline and
        is honored at dispatch: an entry past its deadline is dropped with
        DeadlineError BEFORE it costs forward-pass rows."""
        n = next(iter(batch.values())).shape[0]
        if n > self.buckets.sizes[-1]:
            raise ValueError(f"batch of {n} exceeds max bucket "
                             f"{self.buckets.sizes[-1]}")
        clk = self._stages.clock() if self._stages is not None else None
        handed = clk is not None and clk.stage == PARSE
        if handed:
            clk.stop()
        now = time.perf_counter()
        entry = _Pending({k: np.asarray(v) for k, v in batch.items()},
                         n, now, tag, ctx)
        with self._submit_lock:
            if self._closed:
                raise CoalesceError("coalescer is closed")
            # gauges updated only once the entry is certain to enqueue —
            # a submit racing close() must not inflate queue_depth_rows
            # forever (nothing would ever decrement it)
            with self._stats_lock:
                if self._last_arrival is not None:
                    gap = now - self._last_arrival
                    self._ewma_gap_s = (
                        gap if self._ewma_gap_s is None else
                        (1 - self._EWMA_ALPHA) * self._ewma_gap_s
                        + self._EWMA_ALPHA * gap)
                self._last_arrival = now
                self._pending_rows += n
                self._pending_high = max(self._pending_high,
                                         self._pending_rows)
            self._queue.put(entry)
        entry.event.wait()
        if handed:
            clk.switch(RESPOND, t=entry.released_at)
        if entry.error is not None:
            raise entry.error
        return entry.result

    def close(self) -> None:
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join(timeout=5.0)

    @property
    def alive(self) -> bool:
        """Dispatch thread running and accepting work (readiness signal)."""
        return self._thread.is_alive() and not self._closed

    # --- adaptive linger --------------------------------------------------------

    def linger_s(self) -> float:
        """The effective per-group linger.  Fixed mode returns the knob;
        adaptive mode scales with the EWMA inter-arrival gap so the
        dispatcher waits just long enough for the next few requests under
        load, and barely at all when traffic is sparse."""
        if not self.adaptive:
            return self.max_wait_s
        with self._stats_lock:
            gap = self._ewma_gap_s
        if gap is None or gap >= self.ADAPTIVE_CAP_S:
            return self.ADAPTIVE_MIN_S
        return min(max(self.ADAPTIVE_GAIN * gap, self.ADAPTIVE_MIN_S),
                   self.ADAPTIVE_CAP_S)

    # --- observability --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        effective_linger = self.linger_s()
        wait50, wait95 = self._waits.percentiles(0.50, 0.95)
        with self._stats_lock:
            batches, rows = self._batches, self._rows
            gap = self._ewma_gap_s
            return {
                "batches_formed": batches,
                "rows_total": rows,
                "mean_rows_per_batch": rows / batches if batches else 0.0,
                "max_rows_per_batch": self._max_rows_seen,
                "queue_wait_p50_ms": 1e3 * wait50,
                "queue_wait_p95_ms": 1e3 * wait95,
                "queue_wait_ms_hist": self._wait_hist.snapshot(),
                "forward_ms_hist": self._fwd_hist.snapshot(),
                "device_forward_ms_hist": self._dev_fwd_hist.snapshot(),
                "device_gap_ms_hist": self._dev_gap_hist.snapshot(),
                "queue_depth_rows": self._pending_rows,
                "queue_depth_high_water": self._pending_high,
                "open_groups": self._open_groups,
                "deadline_dropped": self._deadline_dropped,
                "adaptive_linger": self.adaptive,
                "effective_linger_ms": 1e3 * effective_linger,
                "ewma_interarrival_ms": (1e3 * gap if gap is not None
                                         else None),
            }

    # --- dispatch thread ------------------------------------------------------

    def _effective_deadline(self, g: _Group, now: float) -> float:
        # Busy-batching: once a group's rows exactly fill a bucket and no
        # request is waiting, lingering could only help by reaching the
        # NEXT bucket (padding up to the current one is already free), so
        # keep only a short grace for stragglers — near-simultaneous
        # arrivals join, a lone request barely waits.  Below a boundary the
        # full max_wait applies: flushing early would pay for padding rows
        # that a moment of patience could fill.
        if self._queue.empty() and self.buckets.bucket_for(g.rows) == g.rows:
            if g.grace_at is None:
                g.grace_at = now
            return min(g.deadline, g.grace_at + self.boundary_grace_s)
        g.grace_at = None
        return g.deadline

    def _run(self) -> None:
        clk = self._clock = (self._stages.clock()
                             if self._stages is not None else None)
        if clk is not None:
            clk.switch(COLLECT)
        try:
            self._loop()
        finally:
            if clk is not None:
                clk.stop()

    def _loop(self) -> None:
        clk = self._clock
        groups: Dict[Any, _Group] = {}
        while True:
            now = time.perf_counter()
            for sig in list(groups):           # flush expired sub-queues
                if self._effective_deadline(groups[sig], now) <= now:
                    self._execute(groups.pop(sig).entries)
            if groups:
                timeout = max(
                    min(self._effective_deadline(g, now) - now
                        for g in groups.values()), 0.0)
            else:
                timeout = IDLE_POLL_S          # idle poll for the sentinel
            with self._stats_lock:
                self._open_groups = len(groups)
            if clk is not None:
                clk.switch(LINGER if groups else WAIT)
            try:
                entry = self._queue.get(timeout=timeout)
            except queue.Empty:
                if clk is not None:
                    clk.switch(COLLECT)
                    if not groups:             # no work: no host gap
                        self._prev_fwd_end = None
                if self._closed and not groups:
                    break
                continue
            if clk is not None:
                clk.switch(COLLECT)
            if entry is None:                  # close sentinel
                for g in groups.values():      # serve what we have
                    self._execute(g.entries)
                break
            now = time.perf_counter()          # get() may have blocked long
            sig = entry.signature()
            g = groups.get(sig)
            if g is not None and g.rows + entry.n > self.max_rows:
                self._execute(groups.pop(sig).entries)   # full: flush, restart
                g = None
            if g is None:
                groups[sig] = g = _Group(entry, now + self.linger_s())
            else:
                g.entries.append(entry)
                g.rows += entry.n
            if entry.ctx is not None and entry.ctx.deadline_s is not None:
                # a deadline-carrying entry must not rot in a half-filled
                # group past the moment it could still be served: flush one
                # forward's worth of time BEFORE the deadline so dispatch
                # happens while the entry is still live
                g.deadline = min(g.deadline,
                                 max(entry.ctx.deadline_s
                                     - self._fwd_margin_s(), now))
            if g.rows >= self.max_rows:
                self._execute(groups.pop(sig).entries)
        self._drain_on_close()

    def _fwd_margin_s(self) -> float:
        """How far ahead of a request deadline a group should flush — one
        observed forward's worth (EWMA), clamped to [1, 50] ms."""
        with self._stats_lock:
            e = self._ewma_fwd_s
        return min(max(e if e is not None else 0.002, 1e-3), 50e-3)

    def _execute(self, group: Sequence[_Pending]) -> None:
        clk = self._clock
        if clk is not None:
            clk.switch(MERGE)
        now = time.perf_counter()
        # deadline hand-off: entries already past their deadline are
        # dropped HERE — before their rows cost any forward-pass work —
        # and their handler threads get DeadlineError (504 upstream)
        expired = [e for e in group if e.expired(now)]
        group = [e for e in group if not e.expired(now)]
        # release the expired entries' handler threads NOW — their 504
        # must not also wait out the surviving group's forward pass
        expired_rows = sum(e.n for e in expired)
        for e in expired:
            tr = getattr(e.ctx, "trace", None)
            if tr is not None:
                tr.event("deadline_drop", t=now, stage="coalesce",
                         waited_ms=round(1e3 * (now - e.enqueued_at), 3))
            e.error = DeadlineError(
                f"deadline exceeded in coalesce queue after "
                f"{1e3 * (now - e.enqueued_at):.1f}ms")
        if expired:
            with self._stats_lock:
                self._deadline_dropped += len(expired)
                self._pending_rows = max(0,
                                         self._pending_rows - expired_rows)
            for e in expired:
                self._release(e)
        rows = sum(e.n for e in group)
        for e in group:
            tr = getattr(e.ctx, "trace", None)
            if tr is not None:
                tr.span("coalesce_queue", e.enqueued_at, now, rows=e.n)
                tr.event("coalesce_group", t=now, rows=rows,
                         requests=len(group))
        try:
            if group:
                merged = {k: np.concatenate([e.batch[k] for e in group])
                          for k in group[0].batch}
                if clk is not None:
                    clk.switch(LAUNCH)
                    cuda = self._cuda_device()
                    begin = _device_mark(cuda)
                t_fwd = time.perf_counter()
                if self._fwd_nparams >= 3:
                    out = self._forward(merged, group[0].tag,
                                        [e.ctx for e in group])
                elif self._fwd_nparams == 2:
                    out = self._forward(merged, group[0].tag)
                else:
                    out = self._forward(merged)
                if clk is not None:
                    end = _device_mark(cuda)
                    clk.switch(SYNC)
                out_np = _tree_to_numpy(out)
                fwd_s = time.perf_counter() - t_fwd
                if clk is not None:
                    clk.switch(SCATTER)
                    self._observe_device(begin, end)
                with self._stats_lock:
                    self._ewma_fwd_s = (
                        fwd_s if self._ewma_fwd_s is None else
                        0.8 * self._ewma_fwd_s + 0.2 * fwd_s)
                self._fwd_hist.observe(1e3 * fwd_s)
                for e in group:
                    tr = getattr(e.ctx, "trace", None)
                    if tr is not None:
                        tr.span("coalesce_forward", t_fwd, t_fwd + fwd_s,
                                rows=rows)
                off = 0
                for e in group:
                    e.result = _tree_slice(out_np, off, off + e.n)
                    off += e.n
        except BaseException as err:       # noqa: BLE001 — scattered to callers
            for e in group:
                e.error = err
        finally:
            if clk is not None and clk.stage != SCATTER:
                clk.switch(SCATTER)
            with self._stats_lock:
                if group:
                    self._batches += 1
                    self._rows += rows
                    self._max_rows_seen = max(self._max_rows_seen, rows)
                self._pending_rows = max(0, self._pending_rows - rows)
            for e in group:
                e.wait_s = now - e.enqueued_at
                self._waits.add(e.wait_s)
                tr = getattr(e.ctx, "trace", None)
                self._wait_hist.observe(
                    1e3 * e.wait_s,
                    tr.trace_id if tr is not None else None)
            for e in group:
                self._release(e)
            if clk is not None:
                clk.switch(COLLECT)

    def _release(self, e: _Pending) -> None:
        """Wake ``e``'s handler thread, stamping the moment (its
        ``frontend.respond`` starts there) where stages are recorded."""
        if self._stages is not None:
            e.released_at = time.perf_counter()
        e.event.set()

    def _cuda_device(self) -> Optional[torch.device]:
        dev = self._device_of() if self._device_of is not None else None
        return dev if dev is not None and dev.type == "cuda" else None

    def _observe_device(self, begin, end) -> None:
        """One forward's marks (``_device_mark``), read once the host has
        the logits: the device has passed both, so reading them waits for
        nothing."""
        prev, self._prev_fwd_end = self._prev_fwd_end, end
        if isinstance(begin, float):
            self._dev_fwd_hist.observe(1e3 * (end - begin))
            if isinstance(prev, float):
                self._dev_gap_hist.observe(1e3 * (begin - prev))
            return
        self._dev_fwd_hist.observe(begin.elapsed_time(end))
        if prev is not None and not isinstance(prev, float):
            self._dev_gap_hist.observe(prev.elapsed_time(begin))

    def _drain_on_close(self) -> None:
        err = CoalesceError("coalescer closed with requests in flight")
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                return
            if entry is None:
                continue
            entry.error = err
            with self._stats_lock:
                self._pending_rows = max(0, self._pending_rows - entry.n)
            self._release(entry)


def _device_mark(cuda: Optional[torch.device]):
    """A point on the device's clock: a timing CUDA event recorded on the
    current stream of ``cuda``, or, for a forward that runs on the host
    and has finished when it returns, the host clock."""
    if cuda is None:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(cuda))
    return ev


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_numpy(v) for v in tree)
    return to_numpy(tree)


def _tree_slice(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _tree_slice(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_slice(v, lo, hi) for v in tree)
    return tree[lo:hi]
