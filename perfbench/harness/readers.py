"""The arithmetic of the metrics' readers, shared by the small files
under ``metrics/``: each reads one run (``bench.Run``) and returns a
number, or None where the run holds nothing to read."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from perfbench.costs import flops as fl
from perfbench.costs import k1, peaks
from perfbench.harness.traffic import Mix

# a request that failed or was never answered counts as missing every
# latency limit: it takes the longest wait a run allows
FAILED_LATENCY_S = 120.0


def latencies_ms(run) -> np.ndarray:
    """Every request of the window, from when it was due to the last byte
    of its answer; failed requests count as FAILED_LATENCY_S."""
    return np.array([1e3 * (r.latency_s if r.ok else FAILED_LATENCY_S)
                     for r in run.results])


def latency_percentile_ms(run, q: float) -> Optional[float]:
    lat = latencies_ms(run)
    return float(np.percentile(lat, q)) if lat.size else None


def rows_per_s(run) -> Optional[float]:
    """Rows answered with 200, over the window: from its opening to the
    last answer of a request it sent (so the tail of the last requests is
    in the time as their rows are in the count)."""
    rows = sum(r.tokens.shape[0] for r in run.answered)
    span = run.last_done - run.t_start
    return rows / span if rows and span > 0 else None


def _delta(run, *path):
    a, b = run.stats_before, run.stats_after
    for k in path:
        a, b = a[k], b[k]
    return b - a


def rows_per_forward(run) -> Optional[float]:
    """Rows the coalescer put into a forward, on average over the window."""
    batches = _delta(run, "coalesce", "batches_formed")
    return _delta(run, "coalesce", "rows_total") / batches if batches else None


def padded_rows_pct(run) -> Optional[float]:
    """Padding's share of the rows the window's forwards ran, in percent."""
    rows = sum(n for n, _ in run.forwards)
    return 100.0 * sum(p for _, p in run.forwards) / rows if rows else None


def useful_row_flops(run) -> Optional[float]:
    """Useful FLOPs of one row through every member, averaged over the
    rows answered in the window."""
    arch = run.config["arch"]
    seqs = [r.tokens.shape[1] for r in run.answered
            for _ in range(r.tokens.shape[0])]
    if not seqs:
        return None
    members = len(run.config["members"])
    return members * float(np.mean([fl.row_flops(arch, s) for s in seqs]))


def forward_mfu_pct(run) -> Optional[float]:
    """Useful FLOPs of the rows forwarded in the window over the
    forwards' time at the configuration's peak, in percent."""
    rows = _delta(run, "coalesce", "rows_total")
    fwd_s = _delta(run, "coalesce", "forward_ms_hist", "sum") / 1e3
    per_row = useful_row_flops(run)
    if not rows or fwd_s <= 0 or per_row is None:
        return None
    peak = peaks.FLOPS_BY_DTYPE[run.config["arch"]["dtype"]]
    return 100.0 * rows * per_row / (fwd_s * peak)


def fixed_batch(run) -> Optional[tuple]:
    """(B, S) where every forward of the mix runs at one shape: each
    request fills the largest bucket, at one sequence length."""
    shapes = set(Mix(run.traffic, 0, 1).shapes)
    top = int(run.config["max_batch"])
    if len(shapes) == 1:
        rows, seq = shapes.pop()
        if rows == top:
            return top, seq
    return None


def k1_roofline_pct(run, kernels: Sequence[str]) -> Optional[float]:
    """K1's forward launches in the traced sub-window: the least time the
    card needs for them (the frozen bound, at the cell's one shape) over
    the time they took, in percent."""
    if run.profile is None:
        return None
    shape = fixed_batch(run)
    if shape is None:
        return None
    n, t = run.profile.kernel_time("|".join(kernels))
    if not n or t <= 0:
        return None
    B, S = shape
    a = run.config["arch"]
    itemsize = 2 if a["dtype"] in ("bfloat16", "float16") else 4
    bound = k1.launch_bound_s(B, S, a["num_heads"], a["num_kv_heads"],
                              a["head_dim"], itemsize,
                              window=a.get("sliding_window"),
                              flops_per_s=peaks.FLOPS_BY_DTYPE[a["dtype"]])
    return 100.0 * n * bound / t


def device_idle_pct(run) -> Optional[float]:
    """Share of the traced sub-window in which no operation ran on the
    device, in percent (nothing where the trace caught no kernel: the
    profiler lost the device's activity, the device was not idle)."""
    p = run.profile
    if p is None or p.window_s <= 0 or not p.kernels:
        return None
    return 100.0 * max(0.0, 1.0 - p.busy_s / p.window_s)
