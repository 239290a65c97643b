"""The arithmetic of the metrics that read the program's own stage
recorder and counters in ``/metrics``: ``stages`` (wall and CPU time per
stage of the /v1/infer path), ``coalesce.device_forward_ms_hist`` and
``coalesce.device_gap_ms_hist`` (each forward and the wait before it, on
the device's clock), and ``ensemble_batches`` (the batcher's rows and
padding).  Each is read as its change across the window (``run.
stats_before`` to ``run.stats_after``), and is None where the program
reports nothing to read there: a program without the recorder, or one
running with tracing off."""

from __future__ import annotations

from typing import Optional

# the dispatch thread's stages in which it holds work and runs Python of
# its own (the loop's bookkeeping, the merge, the hand-back)
HELD = ("coalesce.collect", "coalesce.merge", "coalesce.scatter")
LAUNCH = "coalesce.launch"
FRONTEND = ("frontend.parse", "frontend.respond")


def delta(run, *path) -> Optional[float]:
    """The change of the number at ``path`` across the window; None where
    either document lacks it."""
    a, b = run.stats_before, run.stats_after
    for k in path:
        if not isinstance(a, dict) or not isinstance(b, dict) \
                or k not in a or k not in b:
            return None
        a, b = a[k], b[k]
    if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
        return None
    return float(b - a)


def stage_delta(run, stage: str, key: str) -> Optional[float]:
    """``key`` of one stage: ``count`` or ``sum`` (wall ms) of its
    histogram, or ``cpu_ms``."""
    if key == "cpu_ms":
        return delta(run, "stages", stage, "cpu_ms")
    return delta(run, "stages", stage, "wall_ms_hist", key)


def idle_between_forwards_pct(run) -> Optional[float]:
    """The device's wait between forwards over its time in and between
    them, on its own clock, in percent."""
    gap = delta(run, "coalesce", "device_gap_ms_hist", "sum")
    fwd = delta(run, "coalesce", "device_forward_ms_hist", "sum")
    n = delta(run, "coalesce", "device_forward_ms_hist", "count")
    if gap is None or fwd is None or not n or gap + fwd <= 0:
        return None
    return 100.0 * gap / (gap + fwd)


def dispatch_stall_ms(run) -> Optional[float]:
    """Per forward, the time the dispatch thread held work and did not
    run: wall less CPU time of its bookkeeping, merge and hand-back."""
    forwards = stage_delta(run, LAUNCH, "count")
    parts = [(stage_delta(run, s, "sum"), stage_delta(run, s, "cpu_ms"))
             for s in HELD]
    if not forwards or any(w is None or c is None for w, c in parts):
        return None
    return sum(w - c for w, c in parts) / forwards


def batcher_padded_rows_pct(run) -> Optional[float]:
    """Padding's share of the rows the batcher's forwards ran, in
    percent, from its own counters."""
    rows = delta(run, "ensemble_batches", "rows_total")
    padded = delta(run, "ensemble_batches", "padded_rows_total")
    if rows is None or padded is None or rows + padded <= 0:
        return None
    return 100.0 * padded / (rows + padded)


def frontend_ms(run) -> Optional[float]:
    """A request's mean time in the front end: its parse (the body in hand
    to the coalescer) plus its respond (its release by the dispatcher to
    the last byte written), each a mean over the window's requests."""
    total = 0.0
    for s in FRONTEND:
        n, ms = stage_delta(run, s, "count"), stage_delta(run, s, "sum")
        if not n or ms is None:
            return None
        total += ms / n
    return total
