"""Metric primitives shared by the core scheduler and the serving plane.

Two bounded-memory replacements for the ad-hoc "append every sample to a
list" pattern that previously backed /metrics percentiles:

  * ``Histogram`` — fixed log-spaced buckets with cumulative counts and an
    exact sum, i.e. the Prometheus histogram data model.  Memory is O(1)
    regardless of request count, merging across scrapes is trivial, and
    quantiles are estimated by linear interpolation inside the bucket that
    crosses the target rank.  Each histogram also keeps a SLOW-REQUEST
    EXEMPLAR: the trace id of the largest observation seen, so a p99 spike
    on a dashboard links straight to `GET /v1/trace/{id}`.

  * ``Reservoir`` — Vitter algorithm-R uniform reservoir sampling.  Where
    the serving layer still wants near-exact percentiles over the full
    request history (not a recency window, not a bucket estimate), the
    reservoir holds a fixed-size uniform sample of ALL observations.  The
    previous trimmed windows kept the most recent 2-4k samples — a bound,
    but a biased one; the reservoir's bound is explicit and unbiased.

  * ``Stages`` — aggregate wall and CPU time per named stage of a serving
    thread (the coalescer's dispatch loop, the HTTP handlers' parse and
    respond), with one ``StageClock`` per thread that switches from one
    stage to the next so the stages tile the thread's time.  While the
    app's own profile capture records (``ranges``), each stage is also a
    profiler range ``flexserve.<stage>``, on the trace's clock beside the
    kernels.

This module lives in ``repro.core`` (not ``repro.serving``) because the
scheduler — a core component — feeds these directly; the serving-plane
tracer builds on top in ``repro.serving.telemetry``.
"""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import torch.autograd.profiler as _autograd_profiler


def pctl(sorted_vals: Sequence[float], p: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sample (0 if empty)."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(p * (len(sorted_vals) - 1)))]


# log-spaced latency buckets (milliseconds): ~1-2.5-5 per decade across
# the range a serving-plane stage can plausibly take, 100us .. 60s
LATENCY_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
                      30000.0, 60000.0)

# log-spaced byte buckets (powers of 4): 4 B .. 256 MiB
BYTES_BUCKETS = tuple(float(4 ** k) for k in range(1, 15))


class Histogram:
    """Fixed-bucket histogram (Prometheus data model) with an exemplar.

    ``observe`` is O(log buckets) and allocation-free on the hot path; the
    per-instance lock only matters for cross-thread observers (the
    scheduler's histograms are single-writer, the coalescer's are not).
    """

    __slots__ = ("bounds", "counts", "count", "sum", "exemplar_value",
                 "exemplar_trace_id", "_lock")

    def __init__(self, bounds: Sequence[float] = LATENCY_MS_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be ascending")
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.exemplar_value: Optional[float] = None
        self.exemplar_trace_id: Optional[str] = None
        self._lock = threading.Lock()

    def _bucket_index(self, value: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:                       # first bound >= value
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        if value < 0 or math.isnan(value):
            value = 0.0
        with self._lock:
            self.counts[self._bucket_index(value)] += 1
            self.count += 1
            self.sum += value
            # slow-request exemplar: the largest observation so far, so a
            # tail-latency spike on a dashboard names a queryable trace
            if trace_id is not None and (self.exemplar_value is None
                                         or value >= self.exemplar_value):
                self.exemplar_value = value
                self.exemplar_trace_id = trace_id

    def percentile(self, p: float) -> float:
        """Quantile estimate: linear interpolation inside the bucket whose
        cumulative count crosses rank ``p * count`` (Prometheus'
        ``histogram_quantile`` semantics; 0 when empty)."""
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            rank = p * total
            cum = 0.0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                prev_cum = cum
                cum += c
                if cum >= rank:
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    hi = (self.bounds[i] if i < len(self.bounds)
                          else self.bounds[-1])   # +Inf bucket: clamp
                    frac = (rank - prev_cum) / c
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            return self.bounds[-1]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able snapshot: bucket upper bounds, CUMULATIVE counts
        (Prometheus ``le`` semantics), exact count/sum, and the slow
        exemplar.  The ``le``/``counts``/``count``/``sum`` key set is what
        the text-exposition renderer keys on."""
        with self._lock:
            cum: List[int] = []
            running = 0
            for c in self.counts:
                running += c
                cum.append(running)
            out: Dict[str, Any] = {
                "le": [*self.bounds, "+Inf"],
                "counts": cum,
                "count": self.count,
                "sum": self.sum,
            }
            if self.exemplar_trace_id is not None:
                out["exemplar"] = {"trace_id": self.exemplar_trace_id,
                                   "value": self.exemplar_value}
            return out


class Reservoir:
    """Fixed-size uniform sample of an unbounded observation stream
    (Vitter's algorithm R).  Every observation ever added has equal
    probability of being in the sample, so percentiles computed from it
    estimate the FULL distribution — unlike a recency window — while
    memory stays O(size) forever."""

    __slots__ = ("size", "samples", "n", "_rng", "_lock")

    def __init__(self, size: int = 1024, seed: int = 0):
        if size < 1:
            raise ValueError("reservoir size must be >= 1")
        self.size = size
        self.samples: List[float] = []
        self.n = 0                        # observations offered, lifetime
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self.n += 1
            if len(self.samples) < self.size:
                self.samples.append(value)
                return
            j = self._rng.randrange(self.n)
            if j < self.size:
                self.samples[j] = value

    def percentile(self, p: float) -> float:
        with self._lock:
            return pctl(sorted(self.samples), p)

    def percentiles(self, *ps: float) -> List[float]:
        """Several quantiles from ONE sort of the current sample."""
        with self._lock:
            s = sorted(self.samples)
        return [pctl(s, p) for p in ps]

    def __len__(self) -> int:
        with self._lock:
            return len(self.samples)


class _Stage:
    """One stage's wall-time histogram (ms) and summed thread CPU time."""

    __slots__ = ("hist", "cpu_ms", "_lock")

    def __init__(self):
        self.hist = Histogram()
        self.cpu_ms = 0.0
        self._lock = threading.Lock()

    def add(self, wall_ms: float, cpu_ms: float) -> None:
        self.hist.observe(wall_ms)
        with self._lock:
            self.cpu_ms += cpu_ms


class Stages:
    """Wall time (a ``Histogram``, ms) and the thread's CPU time
    (``time.thread_time``, ms) per stage name, from every thread that
    records.  A stage's wall time less its CPU time is time its thread
    held the stage and did not run: blocked, or waiting for the
    interpreter lock.  The CPU time is as fine as the host's thread clock:
    where that moves in 10 ms steps (as on the H100 host these stages were
    first measured on), a stage's ``cpu_ms`` is a sample, fair over many
    stages, not a reading of one short stage.  The stage ``names`` are
    fixed at construction and reported from the start (zeroed), so the
    snapshot's key set does not depend on the traffic seen.

    ``ranges`` is set by the app's profile capture (``DeviceProfiler``)
    while it records, and only then does a stage open a profiler range:
    on an H100 host, ranges recorded under a session that records every
    thread took the overloaded /v1/infer cell's device idle from 4-10% to
    13-51% and lost every kernel of the session in 4 of 13 runs, so a
    session started outside the app gets none."""

    RANGE_PREFIX = "flexserve."

    def __init__(self, names: Sequence[str]):
        self.ranges = False
        self._stages: Dict[str, _Stage] = {n: _Stage() for n in names}
        self._local = threading.local()

    def clock(self) -> "StageClock":
        """The calling thread's clock (made on first use)."""
        c = getattr(self._local, "clock", None)
        if c is None:
            c = self._local.clock = StageClock(self)
        return c

    def add(self, name: str, wall_ms: float, cpu_ms: float) -> None:
        self._stages[name].add(wall_ms, cpu_ms)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {n: {"wall_ms_hist": st.hist.snapshot(), "cpu_ms": st.cpu_ms}
                for n, st in sorted(self._stages.items())}


class StageClock:
    """One thread's current stage.  ``switch`` ends the open stage and
    opens the next at the same instant, so the stages a thread switches
    through tile its time with no gap; ``stop`` ends the open stage and
    opens none.  Not shared between threads (``Stages.clock``)."""

    __slots__ = ("_stages", "stage", "_t", "_cpu", "_range")

    def __init__(self, stages: Stages):
        self._stages = stages
        self.stage: Optional[str] = None
        self._t = 0.0
        self._cpu = 0.0
        self._range = None

    def switch(self, name: str, t: Optional[float] = None) -> None:
        """Open ``name`` now (its wall time from ``t``, a
        ``time.perf_counter`` stamp, where given: an earlier moment at
        which another thread handed this one its work)."""
        now, cpu = time.perf_counter(), time.thread_time()
        self._close(now, cpu)
        self.stage, self._t, self._cpu = name, (now if t is None else t), cpu
        if self._stages.ranges:
            self._range = _autograd_profiler.record_function(
                Stages.RANGE_PREFIX + name)
            self._range.__enter__()

    def stop(self) -> None:
        if self.stage is not None:
            self._close(time.perf_counter(), time.thread_time())
            self.stage = None

    def _close(self, now: float, cpu: float) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self.stage is not None:
            self._stages.add(self.stage, 1e3 * (now - self._t),
                             1e3 * (cpu - self._cpu))
