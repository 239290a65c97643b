"""Request-plane telemetry: span tracing, a flight recorder, Prometheus
text exposition, and on-demand device profiling.  The port of
``repro/serving/telemetry.py``: ``Trace``, ``FlightRecorder`` and
``prometheus_exposition`` are copies; ``DeviceProfiler`` captures with
``torch.profiler`` in place of ``jax.profiler``.

FlexServe's pitch is operational control, and this module is the
measurement substrate behind it.  Four pieces:

``Trace`` / ``FlightRecorder``
    A low-overhead per-request timeline keyed by the ``trace_id`` that
    the admission plane threads socket->device.  Every plane appends
    **spans** (named intervals: queue wait, prefill forward, coalesce
    wait), **events** (point-in-time decisions: admitted, shed, preempt,
    resume) and **counters** (aggregates too hot to record individually:
    per-tick decode host/device/transfer split, stream writes).  The
    recorder keeps all in-flight traces plus a ring buffer of the last N
    completed ones, queryable via ``GET /v1/trace/{id}``, and emits one
    structured JSON log line per completed request on the
    ``flexserve.trace`` logger.

    Overhead discipline: hooks are attached to the request object once
    at admission (``ctx.trace``); every hot-path call site guards with a
    plain ``if tr is not None`` so a server built with ``trace=False``
    pays one attribute load per site.  Per decode TICK the cost is a few
    dict increments — no allocation, no locking on the single-writer
    driver thread.

``prometheus_exposition``
    Renders the existing ``/metrics`` JSON document as Prometheus text
    format (version 0.0.4).  It is a generic walker: nested dicts
    flatten to ``flexserve_<section>_<key>`` gauges; any sub-dict shaped
    like a ``core.telemetry.Histogram`` snapshot (``le`` / ``counts`` /
    ``count`` / ``sum``) renders as a real histogram family with
    cumulative ``_bucket{le=...}`` series.  Because it walks the JSON,
    new stats keys become scrapeable without touching this module.

``DeviceProfiler``
    Time-boxed on-demand capture behind ``POST /v1/debug/profile``.
    ``mode="torch"`` (the default) runs ``torch.profiler`` over the time
    box and writes a Chrome trace plus a table of device time by kernel
    name; ``mode="python"`` samples ``sys._current_frames()`` — aimed
    at the scheduler driver thread — and writes a collapsed-stack JSON.
    One capture at a time, duration clamped, artifacts under a
    configurable directory (``launch/serve.py --profile-dir``).

``Histogram`` / ``Reservoir`` are re-exported from ``core.telemetry``
(they live in core so the scheduler can use them without importing the
serving package).
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import re
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

from repro_torch.core.telemetry import (  # noqa: F401  (re-exported)
    BYTES_BUCKETS,
    LATENCY_MS_BUCKETS,
    Histogram,
    Reservoir,
    Stages,
    pctl,
)

logger = logging.getLogger("flexserve.trace")

__all__ = [
    "Histogram", "Reservoir", "pctl",
    "LATENCY_MS_BUCKETS", "BYTES_BUCKETS",
    "Trace", "FlightRecorder", "prometheus_exposition", "DeviceProfiler",
]


# --------------------------------------------------------------------------
# span tracer + flight recorder
# --------------------------------------------------------------------------

class Trace:
    """Timeline of one request: spans, events, counters.

    All timestamps are ``time.perf_counter()`` seconds (same clock as
    ``RequestContext.arrival_s``); snapshots convert to milliseconds
    relative to trace start.  Appends from different threads are safe
    without a lock (list.append / single-writer counters); ``finish`` is
    idempotent under a lock so racing terminators (stream sink vs HTTP
    handler) record exactly one outcome — first caller wins.
    """

    __slots__ = ("trace_id", "plane", "client", "priority", "start_s",
                 "start_unix", "end_s", "status", "finish_reason", "error",
                 "spans", "events", "counters", "attrs", "_recorder",
                 "_lock", "streaming")

    def __init__(self, trace_id: str, plane: str,
                 client: Optional[str] = None, priority: str = "interactive",
                 start_s: Optional[float] = None,
                 recorder: Optional["FlightRecorder"] = None):
        self.trace_id = trace_id
        self.plane = plane
        self.client = client
        self.priority = priority
        self.start_s = time.perf_counter() if start_s is None else start_s
        self.start_unix = time.time()
        self.end_s: Optional[float] = None
        self.status: Optional[int] = None
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.spans: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.attrs: Dict[str, Any] = {}
        self._recorder = recorder
        self._lock = threading.Lock()
        self.streaming = False

    # -- recording ---------------------------------------------------------

    def span(self, name: str, t0: float, t1: Optional[float] = None,
             **attrs: Any) -> None:
        """Record a completed interval [t0, t1] (perf_counter seconds)."""
        if t1 is None:
            t1 = time.perf_counter()
        rec = {"name": name, "t0": t0, "t1": t1}
        if attrs:
            rec["attrs"] = attrs
        self.spans.append(rec)

    def event(self, name: str, t: Optional[float] = None,
              **attrs: Any) -> None:
        """Record a point-in-time occurrence."""
        rec: Dict[str, Any] = {"name": name,
                               "t": time.perf_counter() if t is None else t}
        if attrs:
            rec["attrs"] = attrs
        self.events.append(rec)

    def bump(self, name: str, value: float = 1.0) -> None:
        """Add to an aggregate counter (per-tick decode accounting etc.)."""
        c = self.counters
        c[name] = c.get(name, 0.0) + value

    def annotate(self, key: str, value: Any) -> None:
        """Attach an identity attribute (model version, engine alias)
        consumed by the SLI/usage aggregators at trace-seal time."""
        self.attrs[key] = value

    # -- completion --------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.end_s is not None

    def finish(self, status: int = 200,
               finish_reason: Optional[str] = None,
               error: Optional[str] = None) -> bool:
        """Seal the trace (idempotent; returns True for the sealing call)."""
        with self._lock:
            if self.end_s is not None:
                return False
            self.end_s = time.perf_counter()
            self.status = status
            self.finish_reason = finish_reason
            self.error = error
        rec = self._recorder
        if rec is not None:
            rec._completed(self)
        return True

    # -- export ------------------------------------------------------------

    def _rel_ms(self, t: float) -> float:
        return (t - self.start_s) * 1000.0

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view; all times are ms relative to trace start."""
        end = self.end_s
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "plane": self.plane,
            "client": self.client,
            "priority": self.priority,
            "in_flight": end is None,
            "started_unix": self.start_unix,
            "duration_ms": self._rel_ms(
                time.perf_counter() if end is None else end),
            "status": self.status,
            "finish_reason": self.finish_reason,
            "error": self.error,
            "spans": [
                {"name": s["name"],
                 "start_ms": round(self._rel_ms(s["t0"]), 3),
                 "end_ms": round(self._rel_ms(s["t1"]), 3),
                 "duration_ms": round((s["t1"] - s["t0"]) * 1000.0, 3),
                 **({"attrs": s["attrs"]} if "attrs" in s else {})}
                for s in list(self.spans)
            ],
            "events": [
                {"name": e["name"],
                 "t_ms": round(self._rel_ms(e["t"]), 3),
                 **({"attrs": e["attrs"]} if "attrs" in e else {})}
                for e in list(self.events)
            ],
            "counters": {k: round(v, 3) for k, v in self.counters.items()},
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        out["duration_ms"] = round(out["duration_ms"], 3)
        return out

    def log_line(self) -> str:
        """One-line JSON summary (spans collapsed to name->duration_ms)."""
        snap = self.snapshot()
        durations: Dict[str, float] = {}
        for s in snap["spans"]:
            durations[s["name"]] = round(
                durations.get(s["name"], 0.0) + s["duration_ms"], 3)
        return json.dumps({
            "trace_id": snap["trace_id"],
            "plane": snap["plane"],
            "client": snap["client"],
            "priority": snap["priority"],
            "status": snap["status"],
            "finish_reason": snap["finish_reason"],
            "error": snap["error"],
            "duration_ms": snap["duration_ms"],
            "spans_ms": durations,
            "events": [e["name"] for e in snap["events"]],
            "counters": snap["counters"],
        }, sort_keys=True)


class FlightRecorder:
    """All in-flight traces + a ring of the last ``capacity`` completed.

    ``begin`` registers a trace; completion (``Trace.finish``) moves it
    from the in-flight table into the ring and logs the JSON summary
    line.  The in-flight table is itself bounded (leaked traces — a bug,
    not a workload — evict oldest-first rather than growing forever).
    """

    def __init__(self, capacity: int = 256,
                 log_fn: Optional[Callable[[str], None]] = None,
                 max_in_flight: Optional[int] = None,
                 on_complete: Optional[Callable[[Trace], None]] = None):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = capacity
        self._ring: "collections.deque[Trace]" = collections.deque(
            maxlen=capacity)
        self._in_flight: "collections.OrderedDict[str, Trace]" = \
            collections.OrderedDict()
        self._max_in_flight = max_in_flight or max(4 * capacity, 1024)
        self._lock = threading.Lock()
        self._log_fn = log_fn
        # sealed-trace tap: the SLI/usage aggregators subscribe here so
        # they see exactly the stream the recorder sees
        self.on_complete = on_complete
        self._completed_total = 0
        self._leaked_total = 0

    # -- lifecycle ---------------------------------------------------------

    def begin(self, trace_id: str, plane: str,
              client: Optional[str] = None,
              priority: str = "interactive",
              start_s: Optional[float] = None) -> Trace:
        tr = Trace(trace_id, plane, client=client, priority=priority,
                   start_s=start_s, recorder=self)
        with self._lock:
            self._in_flight[trace_id] = tr
            while len(self._in_flight) > self._max_in_flight:
                _, leaked = self._in_flight.popitem(last=False)
                self._leaked_total += 1
                self._ring.append(leaked)
        return tr

    def _completed(self, tr: Trace) -> None:
        with self._lock:
            self._in_flight.pop(tr.trace_id, None)
            self._ring.append(tr)
            self._completed_total += 1
        log = self._log_fn
        try:
            if log is not None:
                log(tr.log_line())
            elif logger.isEnabledFor(logging.INFO):
                logger.info("%s", tr.log_line())
        except Exception:
            pass   # telemetry must never take down the request path
        hook = self.on_complete
        if hook is not None:
            try:
                hook(tr)
            except Exception:
                pass   # aggregation errors must not reach the request path

    # -- queries -----------------------------------------------------------

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            tr = self._in_flight.get(trace_id)
            if tr is not None:
                return tr
            for t in reversed(self._ring):     # most recent first
                if t.trace_id == trace_id:
                    return t
        return None

    def in_flight(self) -> List[str]:
        with self._lock:
            return list(self._in_flight.keys())

    def recent(self, n: int = 20) -> List[Dict[str, Any]]:
        with self._lock:
            ring = list(self._ring)[-n:]
        return [{"trace_id": t.trace_id, "plane": t.plane,
                 "client": t.client, "status": t.status,
                 "finish_reason": t.finish_reason,
                 "duration_ms": round(((t.end_s or t.start_s) - t.start_s)
                                      * 1000.0, 3),
                 **({"version": t.attrs["version"]}
                    if "version" in t.attrs else {})}
                for t in reversed(ring)]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "in_flight": len(self._in_flight),
                "completed": len(self._ring),
                "completed_total": self._completed_total,
                "leaked_total": self._leaked_total,
            }


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")
_HIST_KEYS = {"le", "counts", "count", "sum"}


def _is_histogram(d: Mapping[str, Any]) -> bool:
    return (_HIST_KEYS.issubset(d.keys())
            and isinstance(d.get("le"), (list, tuple))
            and isinstance(d.get("counts"), (list, tuple)))


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _sanitize(part: str) -> str:
    s = _NAME_SANITIZE.sub("_", str(part)).strip("_")
    return s or "x"


def _render_histogram(name: str, d: Mapping[str, Any],
                      lines: List[str]) -> None:
    lines.append(f"# TYPE {name} histogram")
    for le, c in zip(d["le"], d["counts"]):
        le_s = "+Inf" if le in ("+Inf", None) else _fmt(float(le))
        lines.append(f'{name}_bucket{{le="{le_s}"}} {int(c)}')
    lines.append(f"{name}_sum {_fmt(float(d['sum']))}")
    lines.append(f"{name}_count {int(d['count'])}")
    ex = d.get("exemplar")
    if isinstance(ex, Mapping) and ex.get("trace_id"):
        # exemplar as a comment: text format 0.0.4 has no exemplar
        # syntax, but the slow-request trace id must survive the scrape
        lines.append(f'# EXEMPLAR {name} trace_id="{ex["trace_id"]}" '
                     f'value={_fmt(float(ex.get("value") or 0.0))}')


def _walk(name: str, node: Any, lines: List[str]) -> None:
    if isinstance(node, Mapping):
        if _is_histogram(node):
            _render_histogram(name, node, lines)
            return
        for k, v in node.items():
            _walk(f"{name}_{_sanitize(k)}", v, lines)
        return
    if isinstance(node, bool) or isinstance(node, (int, float)):
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(node)}")
    # str / None / lists: not representable as a sample — skipped


def prometheus_exposition(stats: Mapping[str, Any],
                          prefix: str = "flexserve") -> str:
    """Render a ``/metrics`` JSON document as Prometheus text format.

    Generic by design: dict nesting becomes ``_``-joined metric names,
    numeric leaves become gauges, and histogram snapshots (from
    ``core.telemetry.Histogram``) become histogram families.
    String leaves and lists are skipped (they are labels/debug data, not
    samples).
    """
    lines: List[str] = []
    for k, v in stats.items():
        _walk(f"{_sanitize(prefix)}_{_sanitize(k)}", v, lines)
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# on-demand profiling
# --------------------------------------------------------------------------

def all_threads_config():
    """``torch.profiler``'s option to record the host ops of every thread,
    not only the one that starts the session, where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class DeviceProfiler:
    """Time-boxed capture for ``POST /v1/debug/profile``.

    ``mode="torch"`` runs ``torch.profiler.profile`` with the CPU activity
    and, where a CUDA device is visible, the CUDA one, for the time box,
    and writes ``<dir>/torch-<stamp>/trace.json`` (a Chrome trace) and
    ``kernels.json`` (device time by kernel name, largest first).  CUPTI
    records kernels from every thread of the process, so the decode
    driver's kernels are in the table although the capture runs on its
    own thread; the host ops of every thread are recorded too where this
    torch can (``profile_all_threads``), and with them, given the app's
    ``stages``, the /v1/infer path's ``flexserve.<stage>`` ranges, which
    are opened only while such a capture records.  ``mode="python"``
    samples ``sys._current_frames()`` at ~97 Hz and writes collapsed
    stacks as JSON — when
    ``thread_name_prefix`` matches (the decode and coalesce driver threads
    are named ``flexserve-scheduler`` / ``flexserve-coalescer``) only
    those threads are sampled, otherwise all.  ``mode="auto"`` is
    ``torch``.  One capture at a time; duration clamped to
    ``max_duration_ms``.  The capture runs on its own daemon thread and
    ``start`` returns immediately with the artifact path the capture will
    produce; a capture that fails is reported by ``status()``
    (``last_error``, ``last``), never retried in another mode.
    """

    MAX_DURATION_MS = 30_000.0
    MODES = ("auto", "torch", "python")

    def __init__(self, artifact_dir: str = "profiles",
                 thread_name_prefix: str = "flexserve-scheduler",
                 max_duration_ms: float = MAX_DURATION_MS,
                 stages: Optional[Stages] = None):
        self.artifact_dir = artifact_dir
        self.stages = stages
        self.thread_name_prefix = thread_name_prefix
        self.max_duration_ms = max_duration_ms
        self._lock = threading.Lock()
        self._active: Optional[Dict[str, Any]] = None
        self._last: Optional[Dict[str, Any]] = None
        self._seq = 0
        self._captures_total = 0
        self._failures_total = 0

    # -- public ------------------------------------------------------------

    def start(self, duration_ms: float = 1000.0,
              mode: str = "auto") -> Dict[str, Any]:
        """Begin a capture; raises ``RuntimeError`` if one is running."""
        duration_ms = max(10.0, min(float(duration_ms),
                                    self.max_duration_ms))
        if mode not in self.MODES:
            raise ValueError(f"unknown profile mode: {mode!r}")
        resolved = "python" if mode == "python" else "torch"
        with self._lock:
            if self._active is not None:
                raise RuntimeError(
                    "a profile capture is already in progress "
                    f"(artifact: {self._active['artifact']})")
            self._seq += 1
            stamp = f"{int(time.time())}-{self._seq:03d}"
            os.makedirs(self.artifact_dir, exist_ok=True)
            if resolved == "torch":
                artifact = os.path.join(self.artifact_dir, f"torch-{stamp}")
            else:
                artifact = os.path.join(self.artifact_dir,
                                        f"pysample-{stamp}.json")
            info = {"mode": resolved, "artifact": artifact,
                    "duration_ms": duration_ms,
                    "started_unix": time.time()}
            self._active = info
        t = threading.Thread(target=self._run, args=(dict(info),),
                             name="flexserve-profiler", daemon=True)
        t.start()
        return dict(info)

    def status(self) -> Dict[str, Any]:
        """The running capture, the last finished one (``ok``, ``error``)
        and the counts; ``last_error`` is the newest failure's message."""
        with self._lock:
            last = dict(self._last) if self._last else None
            return {"active": dict(self._active) if self._active else None,
                    "captures_total": self._captures_total,
                    "failures_total": self._failures_total,
                    "last": last,
                    "last_error": last.get("error") if last else None}

    # -- capture body ------------------------------------------------------

    def _run(self, info: Dict[str, Any]) -> None:
        error = None
        try:
            if info["mode"] == "torch":
                self._run_torch(info)
            else:
                self._run_python(info)
        except Exception as e:  # noqa: BLE001 — reported through status()
            logger.exception("profile capture failed")
            error = f"{type(e).__name__}: {e}"
        finally:
            with self._lock:
                self._active = None
                self._captures_total += 1
                self._failures_total += error is not None
                self._last = {**info, "ok": error is None, "error": error,
                              "finished_unix": time.time()}

    def _run_torch(self, info: Dict[str, Any]) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(info["artifact"], exist_ok=True)
        with profile(activities=activities,
                     experimental_config=all_threads_config()) as prof:
            if self.stages is not None:
                self.stages.ranges = True
            try:
                time.sleep(info["duration_ms"] / 1000.0)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            finally:
                if self.stages is not None:
                    self.stages.ranges = False
        prof.export_chrome_trace(os.path.join(info["artifact"],
                                              "trace.json"))
        doc = {"mode": "torch", "duration_ms": info["duration_ms"],
               "activities": [a.name for a in activities],
               "device": (torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu"),
               "kernels": device_kernel_table(prof)}
        _write_json(os.path.join(info["artifact"], "kernels.json"), doc)

    def _run_python(self, info: Dict[str, Any]) -> None:
        interval = 1.0 / 97.0          # ~97 Hz, co-prime with common ticks
        deadline = time.monotonic() + info["duration_ms"] / 1000.0
        # collapsed-stack counts per thread name
        stacks: Dict[str, Dict[str, int]] = {}
        samples = 0
        while time.monotonic() < deadline:
            names = {t.ident: t.name for t in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                name = names.get(ident, str(ident))
                if name == "flexserve-profiler":
                    continue
                if self.thread_name_prefix and not name.startswith(
                        self.thread_name_prefix):
                    continue
                parts = []
                f = frame
                while f is not None:
                    code = f.f_code
                    parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                                 f"{code.co_name}:{f.f_lineno}")
                    f = f.f_back
                key = ";".join(reversed(parts))
                per = stacks.setdefault(name, {})
                per[key] = per.get(key, 0) + 1
            samples += 1
            time.sleep(interval)
        doc = {
            "mode": "python",
            "duration_ms": info["duration_ms"],
            "samples": samples,
            "thread_name_prefix": self.thread_name_prefix,
            "threads": {
                name: sorted(
                    ({"stack": k, "count": c} for k, c in per.items()),
                    key=lambda r: -r["count"])
                for name, per in stacks.items()
            },
        }
        _write_json(info["artifact"], doc)


def device_kernel_table(prof) -> List[Dict[str, Any]]:
    """Device time by kernel name from a finished ``torch.profiler``
    capture, largest first: ``[{"name", "device_ms", "calls"}]``.  Only
    device events count (an operator's row repeats its kernels' time)."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append({"name": evt.key, "device_ms": us / 1e3,
                     "calls": int(evt.count)})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def _write_json(path: str, doc: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)
