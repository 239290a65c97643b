"""A traced sub-window of a run: ``torch.profiler`` over a few forwards
in the middle of the measured window, reduced to the device's busy time,
its kernels, the device operations that took most time and the idle
gaps by what the host was doing.  The trace is written to ``TMPDIR``,
read once and deleted."""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
# the host annotation that spans the traced window, in the trace's clock
WINDOW = "perfbench.window"
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameters: ``void (anonymous
    namespace)::flash_attention_wgmma_kernel<128, ...>(...)`` ->
    ``flash_attention_wgmma_kernel``."""
    s = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split()
    return words[-1] if words else name


@dataclass
class Profile:
    """What a traced sub-window saw (seconds)."""

    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    trace_bytes: int = 0

    def kernel_time(self, pattern: str) -> Tuple[int, float]:
        """(launches, summed seconds) of the kernels whose short name
        matches ``pattern`` in full."""
        rx = re.compile(f"(?:.*::)?(?:{pattern})")
        hits = [d for n, _, d in self.kernels if rx.fullmatch(short_name(n))]
        return len(hits), sum(hits)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(events: List[Dict], window_s: float,
                 min_gap_s: float = 20e-6) -> Profile:
    """Chrome-trace events (``ts``/``dur`` in microseconds) -> Profile.
    Where the trace holds the ``WINDOW`` annotation, the window is its
    span and device time outside it is cut off (the profiler records
    kernels while it starts and stops); otherwise ``window_s``."""
    dev, host, span = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "?")
        t0, t1 = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            dev.append((name, t0, t1, cat))
        elif cat in HOST_CATS:
            if name == WINDOW:
                span = (t0, t1)
            else:
                host.append((t0, t1, name))
    # kernels wholly inside the window, for the per-kernel counts
    kernels = [(n, a, b - a) for n, a, b, c in dev if c == "kernel"
               and (span is None or span[0] <= a and b <= span[1])]
    if span is not None:
        window_s = span[1] - span[0]
        dev = [(n, max(a, span[0]), min(b, span[1]), c)
               for n, a, b, c in dev if b > span[0] and a < span[1]]
    merged = union([(a, b) for _, a, b, _ in dev])
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = {}
    for name, a, b, cat in dev:
        key = short_name(name) if cat == "kernel" else cat
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    edges = ([(span[0], span[0])] + merged + [(span[1], span[1])]
             if span is not None else merged)
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(edges, edges[1:])
            if b0 - a1 >= min_gap_s]
    by_host: Dict[str, float] = {}
    host.sort()
    active: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > mid]
        label = (min(active, key=lambda h: h[1] - h[0])[2] if active
                 else "no host op recorded")
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return Profile(window_s, busy, kernels, top, idle)


def every_thread():
    """The profiler's option to record the host ops of every thread (the
    coalescer's dispatch thread launches the forwards), where this torch
    has it, and to build no Python event objects, which the trace file
    does not need."""
    from torch._C._profiler import _ExperimentalConfig
    for kw in ({"profile_all_threads": True, "trace_only": True},
               {"profile_all_threads": True}):
        try:
            return _ExperimentalConfig(**kw)
        except TypeError:
            continue
    return None


class SubWindow:
    """Profiles ``length_s`` seconds from ``start`` (perf_counter).  The
    window opens ``SETTLE_S`` after the profiler starts (its start slows
    the host for a moment).  On the card's machine a trace now and then
    holds no kernel at all (memsets and copies only: 2 of 18 traced runs
    of the yi-9b cells, and all four sessions of one such process): such
    a trace is taken again, without recording the host ops of every
    thread, while the traced window still fits before ``end``."""

    SETTLE_S = 0.5

    def __init__(self, start: float, length_s: float, end: float):
        self.start, self.length_s, self.end = start, length_s, end
        self.profile: Optional[Profile] = None
        self.attempts = 0

    @staticmethod
    def prepare() -> None:
        """Start and stop the profiler once, in set-up: its first session
        in a process initialises the tracer and records nothing."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=every_thread()):
            time.sleep(0.01)

    def __call__(self) -> None:
        now = time.perf_counter()
        if self.start > now:
            time.sleep(self.start - now)
        while True:
            self.attempts += 1
            self.profile = self._trace(all_threads=self.attempts == 1)
            if self.profile.kernels or time.perf_counter() + self.SETTLE_S \
                    + 2 * self.length_s > self.end:
                return

    def _trace(self, all_threads: bool = True) -> Profile:
        import torch
        from torch.profiler import ProfilerActivity, profile
        cfg = every_thread() if all_threads else None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=cfg) as prof:
            time.sleep(self.SETTLE_S)
            with torch.profiler.record_function(WINDOW):
                t0 = time.perf_counter()
                time.sleep(self.length_s)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
        fd, path = tempfile.mkstemp(prefix="perfbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        out = reduce_trace(events, t1 - t0)
        out.trace_bytes = size
        return out
