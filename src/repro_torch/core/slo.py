"""Windowed SLIs, per-client/per-version cost accounting, and the SLO
autopilot that promotes or rolls back canary engines from them: the
port's copy of ``repro/core/slo.py`` (pure Python; the port imports
nothing of the JAX package).

The request plane is instrumented — per-request traces with decode cost
counters, histograms, Prometheus exposition; this module aggregates and
acts on those signals, in three pieces:

``SlidingWindow`` / ``SLIStore``
    Ring-of-buckets sliding windows (default 10s buckets x 60 = a 10
    minute horizon).  Each bucket holds O(1) counters — request count,
    errors, deadline misses, a fixed-bucket latency/TTFT histogram row —
    so ingest is a handful of increments per request and a window
    snapshot is a sum over at most ``n_buckets`` buckets, never a scan
    over requests.  ``SLIStore`` keys windows by dimension
    (``("plane", name)``, ``("client", tag)``, ``("version", label)``)
    and is fed once per request at trace-seal time (the flight
    recorder's completion hook), i.e. from the same span/counter stream
    the recorder already sees.  Snapshots report error rate, deadline-
    miss rate, and p50/p95/p99 latency + TTFT interpolated from the
    merged bucket counts over any window length up to the horizon.

``UsageLedger``
    Per-client and per-version cost attribution.  The scheduler already
    attributes decode cost per request in O(1) per tick (cumulative
    share accumulators, attach-mark/detach-flush) and stamps prefill /
    decode token counts on the trace; the ledger rolls those counters up
    by client tag and by model version, split per plane, so
    ``GET /v1/usage`` answers "what did client X / version Y cost"
    in device-ms and tokens.  Conservation is by construction: the
    ledger sums exactly the per-request deltas the scheduler's global
    accumulators sum, so totals match ``/metrics`` within the share of
    still-in-flight requests.

``SLOPolicy`` / ``SLOController``
    Declarative objectives (success rate, p95 latency, deadline-miss
    rate) evaluated SRE-style over two windows — a fast window to catch
    a burning canary quickly, a slow window so one unlucky second can't
    flap an alias — with *burn rate* = observed bad fraction / allowed
    bad fraction.  The controller maps each policy to an engine alias:
    a canary that meets every objective over its qualifying window with
    minimum traffic is PROMOTED (the stable alias re-points to the
    canary's engine); a canary whose burn rate exceeds the threshold in
    BOTH windows is ROLLED BACK (the canary alias re-points to stable's
    engine).  Every decision is appended to a bounded audit log, pushed
    to the flight recorder as a sealed admin trace (queryable like any
    request), and served at ``GET /v1/slo``.

Pure-Python, no device work: lives in ``core`` next to ``telemetry`` so
the scheduler and the serving plane can both import it.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.telemetry import LATENCY_MS_BUCKETS

__all__ = [
    "SlidingWindow", "SLIStore", "UsageLedger",
    "SLOPolicy", "SLOController", "load_policies",
    "ZERO_SLO", "ZERO_USAGE",
]

# /metrics schema-stability constants: these sections are served zeroed
# from boot (before any SLO config / traffic) so scrapers and dashboards
# never see a missing key — same contract as _ZERO_LIFECYCLE and
# ZERO_PAGER_STATS.
ZERO_SLO: Dict[str, Any] = {
    "policies": 0, "evaluations": 0, "decisions": 0,
    "promotions": 0, "rollbacks": 0, "breaches": 0,
}

ZERO_USAGE: Dict[str, Any] = {
    "clients": 0, "versions": 0, "requests": 0, "errors": 0,
    "prefill_tokens": 0, "decode_tokens": 0,
    "device_ms": 0.0, "decode_device_ms": 0.0, "decode_host_ms": 0.0,
    "prefill_ms": 0.0, "transfer_bytes": 0,
}


# --------------------------------------------------------------------------
# sliding-window SLIs
# --------------------------------------------------------------------------

class _Bucket:
    """One time bucket's counters.  ``epoch`` is the absolute bucket
    index; a ring slot whose epoch is stale is reset in place on the next
    write (no background sweeper)."""

    __slots__ = ("epoch", "count", "errors", "deadline_miss",
                 "lat_sum", "lat_counts", "ttft_sum", "ttft_count",
                 "ttft_counts")

    def __init__(self, n_bounds: int):
        self.reset(-1, n_bounds)

    def reset(self, epoch: int, n_bounds: int) -> None:
        self.epoch = epoch
        self.count = 0
        self.errors = 0
        self.deadline_miss = 0
        self.lat_sum = 0.0
        self.lat_counts = [0] * (n_bounds + 1)
        self.ttft_sum = 0.0
        self.ttft_count = 0
        self.ttft_counts = [0] * (n_bounds + 1)


def _pctl_from_counts(counts: Sequence[int], bounds: Sequence[float],
                      total: int, q: float) -> float:
    """Quantile estimate from per-bucket (NON-cumulative) counts by linear
    interpolation inside the crossing bucket; the overflow bucket reports
    its lower edge (there is no finite upper edge to interpolate to)."""
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        prev_cum = cum
        cum += c
        if cum >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            if i >= len(bounds):            # overflow bucket
                return float(bounds[-1])
            hi = bounds[i]
            frac = (rank - prev_cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return float(bounds[-1])


class SlidingWindow:
    """Ring of ``n_buckets`` buckets, each ``bucket_s`` seconds wide.

    ``observe`` is O(log bounds) (one bisect + a few increments); a
    ``snapshot(window_s)`` merges the most recent ``window_s`` worth of
    live buckets.  Clock is ``time.perf_counter`` (the request plane's
    clock) unless the caller passes ``now`` explicitly — tests drive
    synthetic time through that.
    """

    __slots__ = ("bucket_s", "n_buckets", "bounds", "_ring", "total")

    def __init__(self, bucket_s: float = 10.0, n_buckets: int = 60,
                 bounds: Sequence[float] = LATENCY_MS_BUCKETS):
        if bucket_s <= 0 or n_buckets < 2:
            raise ValueError("need bucket_s > 0 and n_buckets >= 2")
        self.bucket_s = float(bucket_s)
        self.n_buckets = int(n_buckets)
        self.bounds = tuple(float(b) for b in bounds)
        self._ring = [_Bucket(len(self.bounds))
                      for _ in range(self.n_buckets)]
        self.total = 0                       # lifetime observations

    @property
    def horizon_s(self) -> float:
        return self.bucket_s * self.n_buckets

    def _bucket(self, now: float) -> _Bucket:
        epoch = int(now // self.bucket_s)
        b = self._ring[epoch % self.n_buckets]
        if b.epoch != epoch:
            b.reset(epoch, len(self.bounds))
        return b

    def observe(self, latency_ms: float, *, error: bool = False,
                deadline_miss: bool = False,
                ttft_ms: Optional[float] = None,
                now: Optional[float] = None) -> None:
        b = self._bucket(time.perf_counter() if now is None else now)
        b.count += 1
        self.total += 1
        if error:
            b.errors += 1
        if deadline_miss:
            b.deadline_miss += 1
        b.lat_sum += latency_ms
        b.lat_counts[bisect.bisect_left(self.bounds, latency_ms)] += 1
        if ttft_ms is not None:
            b.ttft_sum += ttft_ms
            b.ttft_count += 1
            b.ttft_counts[bisect.bisect_left(self.bounds, ttft_ms)] += 1

    def snapshot(self, window_s: float,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Merged SLIs over the trailing ``window_s`` (clamped to the
        ring horizon), INCLUDING the partially-filled current bucket."""
        now = time.perf_counter() if now is None else now
        window_s = min(float(window_s), self.horizon_s)
        epoch_now = int(now // self.bucket_s)
        n_back = max(1, int(math.ceil(window_s / self.bucket_s)))
        lat = [0] * (len(self.bounds) + 1)
        ttft = [0] * (len(self.bounds) + 1)
        count = errors = miss = ttft_n = 0
        lat_sum = ttft_sum = 0.0
        for b in self._ring:
            if not (epoch_now - n_back < b.epoch <= epoch_now):
                continue
            count += b.count
            errors += b.errors
            miss += b.deadline_miss
            lat_sum += b.lat_sum
            ttft_sum += b.ttft_sum
            ttft_n += b.ttft_count
            for i, c in enumerate(b.lat_counts):
                lat[i] += c
            for i, c in enumerate(b.ttft_counts):
                ttft[i] += c
        out = {
            "window_s": window_s,
            "count": count,
            "errors": errors,
            "error_rate": errors / count if count else 0.0,
            "deadline_miss": miss,
            "deadline_miss_rate": miss / count if count else 0.0,
            "latency_ms_sum": round(lat_sum, 3),
            "p50_ms": round(_pctl_from_counts(lat, self.bounds,
                                              count, 0.50), 3),
            "p95_ms": round(_pctl_from_counts(lat, self.bounds,
                                              count, 0.95), 3),
            "p99_ms": round(_pctl_from_counts(lat, self.bounds,
                                              count, 0.99), 3),
            "ttft_p95_ms": round(_pctl_from_counts(ttft, self.bounds,
                                                   ttft_n, 0.95), 3),
        }
        return out

    def slow_count(self, threshold_ms: float, window_s: float,
                   now: Optional[float] = None) -> Tuple[int, int]:
        """(requests slower than ``threshold_ms``, total) over the window
        — bucket-resolution (a request counts as slow when its whole
        latency bucket sits above the threshold)."""
        now = time.perf_counter() if now is None else now
        epoch_now = int(now // self.bucket_s)
        n_back = max(1, int(math.ceil(min(window_s, self.horizon_s)
                                      / self.bucket_s)))
        cut = bisect.bisect_left(self.bounds, threshold_ms) + 1
        slow = total = 0
        for b in self._ring:
            if not (epoch_now - n_back < b.epoch <= epoch_now):
                continue
            total += b.count
            slow += sum(b.lat_counts[cut:])
        return slow, total


class SLIStore:
    """Windows keyed by (dimension, name): per plane, per client tag, per
    model version.  One ``ingest`` per request (trace-seal time) fans out
    to the request's three keys.  The key space is bounded: past
    ``max_keys`` per dimension, new names fold into ``"_overflow"`` so an
    adversarial client-tag stream cannot grow memory without bound."""

    DIMENSIONS = ("plane", "client", "version")

    def __init__(self, bucket_s: float = 10.0, n_buckets: int = 60,
                 max_keys: int = 256):
        self.bucket_s = bucket_s
        self.n_buckets = n_buckets
        self.max_keys = max_keys
        self._lock = threading.Lock()
        self._windows: Dict[Tuple[str, str], SlidingWindow] = {}
        self.ingested_total = 0

    def _window_locked(self, dim: str, name: str) -> SlidingWindow:
        key = (dim, name)
        win = self._windows.get(key)
        if win is None:
            if sum(1 for d, _ in self._windows if d == dim) >= self.max_keys:
                key = (dim, "_overflow")
                win = self._windows.get(key)
                if win is not None:
                    return win
            win = self._windows[key] = SlidingWindow(
                self.bucket_s, self.n_buckets)
        return win

    def ingest(self, *, plane: str, client: Optional[str],
               version: Optional[str], latency_ms: float,
               error: bool = False, deadline_miss: bool = False,
               ttft_ms: Optional[float] = None,
               now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        with self._lock:
            self.ingested_total += 1
            for dim, name in (("plane", plane),
                              ("client", client or "_untagged"),
                              ("version", version or "_unversioned")):
                self._window_locked(dim, name).observe(
                    latency_ms, error=error, deadline_miss=deadline_miss,
                    ttft_ms=ttft_ms, now=now)

    def window(self, dim: str, name: str) -> Optional[SlidingWindow]:
        with self._lock:
            return self._windows.get((dim, name))

    def snapshot(self, window_s: float,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """{dim: {name: sli}} over one window length, for /v1/slo."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            keys = list(self._windows.items())
        out: Dict[str, Dict[str, Any]] = {d: {} for d in self.DIMENSIONS}
        for (dim, name), win in keys:
            out.setdefault(dim, {})[name] = win.snapshot(window_s, now=now)
        return out


# --------------------------------------------------------------------------
# cost attribution
# --------------------------------------------------------------------------

def _zero_usage_entry() -> Dict[str, Any]:
    return {"requests": 0, "errors": 0, "prefill_tokens": 0,
            "decode_tokens": 0, "device_ms": 0.0, "decode_device_ms": 0.0,
            "decode_host_ms": 0.0, "prefill_ms": 0.0, "transfer_bytes": 0,
            "planes": {}}


class UsageLedger:
    """Per-client and per-version rollups of the scheduler's per-request
    cost counters (see module docstring).  ``device_ms`` is the request's
    total device attribution — its share of every decode tick it decoded
    in plus its share of its prefill forward — and is additionally split
    per plane under ``"planes"`` (the paper-methodology ``device_ms x
    plane`` attribution)."""

    def __init__(self, max_keys: int = 256):
        self.max_keys = max_keys
        self._lock = threading.Lock()
        self._clients: Dict[str, Dict[str, Any]] = {}
        self._versions: Dict[str, Dict[str, Any]] = {}
        self._totals = _zero_usage_entry()

    def _entry_locked(self, table: Dict[str, Dict[str, Any]],
                      key: str) -> Dict[str, Any]:
        e = table.get(key)
        if e is None:
            if len(table) >= self.max_keys and "_overflow" != key:
                return self._entry_locked(table, "_overflow")
            e = table[key] = _zero_usage_entry()
        return e

    @staticmethod
    def _add(e: Dict[str, Any], plane: str, error: bool,
             prefill_tokens: float, decode_tokens: float,
             decode_device_ms: float, decode_host_ms: float,
             prefill_ms: float, transfer_bytes: float) -> None:
        e["requests"] += 1
        if error:
            e["errors"] += 1
        e["prefill_tokens"] += int(prefill_tokens)
        e["decode_tokens"] += int(decode_tokens)
        e["decode_device_ms"] += decode_device_ms
        e["decode_host_ms"] += decode_host_ms
        e["prefill_ms"] += prefill_ms
        e["device_ms"] += decode_device_ms + prefill_ms
        e["transfer_bytes"] += int(transfer_bytes)
        p = e["planes"].get(plane)
        if p is None:
            p = e["planes"][plane] = {"requests": 0, "device_ms": 0.0,
                                      "tokens": 0}
        p["requests"] += 1
        p["device_ms"] += decode_device_ms + prefill_ms
        p["tokens"] += int(prefill_tokens + decode_tokens)

    def ingest(self, *, plane: str, client: Optional[str],
               version: Optional[str], error: bool = False,
               counters: Optional[Dict[str, float]] = None) -> None:
        c = counters or {}
        args = (plane, error,
                c.get("prefill_tokens", 0.0), c.get("decode_tokens", 0.0),
                c.get("decode_device_ms", 0.0),
                c.get("decode_host_ms", 0.0), c.get("prefill_ms", 0.0),
                c.get("decode_transfer_bytes", 0.0))
        with self._lock:
            self._add(self._entry_locked(self._clients,
                                         client or "_untagged"), *args)
            self._add(self._entry_locked(self._versions,
                                         version or "_unversioned"), *args)
            self._add(self._totals, *args)

    @staticmethod
    def _round(e: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(e)
        for k in ("device_ms", "decode_device_ms", "decode_host_ms",
                  "prefill_ms"):
            out[k] = round(out[k], 3)
        out["planes"] = {p: {**v, "device_ms": round(v["device_ms"], 3)}
                         for p, v in e["planes"].items()}
        return out

    def totals(self) -> Dict[str, Any]:
        """Flat numeric totals for the /metrics ``usage`` section (the
        ZERO_USAGE schema, populated)."""
        with self._lock:
            t = self._round(self._totals)
            t.pop("planes")
            return {"clients": len(self._clients),
                    "versions": len(self._versions), **t}

    def snapshot(self, client: Optional[str] = None,
                 version: Optional[str] = None) -> Dict[str, Any]:
        """The GET /v1/usage payload, optionally filtered to one client
        tag and/or one version label."""
        with self._lock:
            clients = {k: self._round(v) for k, v in self._clients.items()
                       if client is None or k == client}
            versions = {k: self._round(v) for k, v in self._versions.items()
                        if version is None or k == version}
            return {"clients": clients, "versions": versions,
                    "totals": self._round(self._totals)}


# --------------------------------------------------------------------------
# declarative SLOs + the autopilot
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SLOPolicy:
    """One alias's objectives and autopilot rules.

    Objectives: ``success_rate`` (non-5xx fraction; its complement is the
    error budget), optional ``p95_ms`` latency bound, optional
    ``max_deadline_miss_rate``.  Burn rate = observed bad fraction /
    budgeted bad fraction; a BREACH requires burn > ``burn_threshold`` in
    BOTH the fast and the slow window (multi-window, SRE-style — the
    fast window reacts, the slow window keeps one bad second from
    flapping the alias).  PROMOTION requires every objective met over
    ``qualify_window_s`` with at least ``min_requests`` of real traffic.
    """

    name: str
    alias: str = "canary"
    promote_to: str = "stable"
    plane: str = "generate"
    success_rate: float = 0.99
    p95_ms: Optional[float] = None
    max_deadline_miss_rate: Optional[float] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    burn_threshold: float = 2.0
    min_requests: int = 20
    qualify_window_s: float = 60.0

    def __post_init__(self):
        if not (0.0 < self.success_rate <= 1.0):
            raise ValueError("success_rate must be in (0, 1]")
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        if self.burn_threshold <= 0:
            raise ValueError("burn_threshold must be > 0")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOPolicy":
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SLO policy fields: {sorted(unknown)}")
        if "name" not in d:
            raise ValueError("an SLO policy needs a 'name'")
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def load_policies(source: Any) -> List[SLOPolicy]:
    """Parse policies from a path to a JSON file, a JSON document
    (``{"policies": [...]}`` or a bare list), or a list of dicts /
    SLOPolicy.  ``launch/serve.py --slo-config`` feeds a path here."""
    if isinstance(source, str):
        with open(source) as fh:
            source = json.load(fh)
    if isinstance(source, dict):
        source = source.get("policies", [])
    if not isinstance(source, (list, tuple)):
        raise ValueError("SLO config must be a list of policies or a "
                         "{'policies': [...]} document")
    out = []
    for item in source:
        out.append(item if isinstance(item, SLOPolicy)
                   else SLOPolicy.from_dict(dict(item)))
    return out


@dataclass
class _PolicyState:
    policy: SLOPolicy
    last_decision_s: float = -math.inf
    last_eval: Dict[str, Any] = field(default_factory=dict)


class SLOController:
    """Evaluates policies against the SLI windows and actuates alias
    changes through injected callbacks (the server wires these to the
    lifecycle manager / generation service):

      ``resolve(alias) -> version label or None``
      ``promote(policy) -> result dict``   (flip canary -> stable)
      ``rollback(policy) -> result dict``  (re-point canary at stable)

    Decisions land in a bounded audit log, on the flight recorder as
    sealed ``slo`` traces (so ``GET /v1/trace/slo-...`` and the recent
    ring show them), and on ``GET /v1/slo``.  ``start()`` runs the
    evaluation loop on a daemon thread; tests call ``evaluate()``."""

    def __init__(self, store: SLIStore, policies: Sequence[SLOPolicy], *,
                 resolve: Callable[[str], Optional[str]],
                 promote: Callable[[SLOPolicy], Any],
                 rollback: Callable[[SLOPolicy], Any],
                 recorder: Optional[Any] = None,
                 interval_s: float = 2.0,
                 cooldown_s: Optional[float] = None,
                 max_decisions: int = 256):
        self.store = store
        self._states = [_PolicyState(p) for p in policies]
        self._resolve = resolve
        self._promote = promote
        self._rollback = rollback
        self.recorder = recorder
        self.interval_s = interval_s
        # default cooldown: one slow window after any decision, so the
        # windows actually refill with post-decision traffic before the
        # alias can move again
        self._cooldowns = {p.name: (cooldown_s if cooldown_s is not None
                                    else p.slow_window_s)
                           for p in policies}
        self._lock = threading.Lock()
        self._decisions: List[Dict[str, Any]] = []
        self.max_decisions = max_decisions
        self._seq = 0
        self.evaluations = 0
        self.promotions = 0
        self.rollbacks = 0
        self.breaches = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- policy math -------------------------------------------------------

    def _burn(self, policy: SLOPolicy, sli: Dict[str, Any]) -> float:
        budget = 1.0 - policy.success_rate
        return (sli["error_rate"] / budget) if budget > 0 else (
            math.inf if sli["errors"] else 0.0)

    def _objectives(self, policy: SLOPolicy, win: SlidingWindow,
                    window_s: float, now: float) -> Dict[str, Any]:
        sli = win.snapshot(window_s, now=now)
        out = {"sli": sli, "burn_rate": round(self._burn(policy, sli), 3)}
        failed = []
        if sli["error_rate"] > 1.0 - policy.success_rate:
            failed.append("success_rate")
        if policy.p95_ms is not None and sli["count"] \
                and sli["p95_ms"] > policy.p95_ms:
            failed.append("p95_ms")
        if policy.max_deadline_miss_rate is not None \
                and sli["deadline_miss_rate"] > policy.max_deadline_miss_rate:
            failed.append("deadline_miss_rate")
        out["failed"] = failed
        return out

    def _evaluate_policy(self, st: _PolicyState,
                         now: float) -> Optional[Dict[str, Any]]:
        policy = st.policy
        label = self._resolve(policy.alias)
        stable_label = self._resolve(policy.promote_to)
        if label is None:
            st.last_eval = {"state": "no_target", "alias": policy.alias}
            return None
        win = self.store.window("version", label)
        if win is None:
            st.last_eval = {"state": "no_traffic", "engine": label}
            return None
        fast = self._objectives(policy, win, policy.fast_window_s, now)
        slow = self._objectives(policy, win, policy.slow_window_s, now)
        breach = (fast["burn_rate"] > policy.burn_threshold
                  and slow["burn_rate"] > policy.burn_threshold
                  and fast["sli"]["count"] >= 1)
        # latency/deadline objectives breach on the multi-window rule too
        breach = breach or (
            bool(fast["failed"]) and bool(slow["failed"])
            and bool(set(fast["failed"]) & set(slow["failed"])
                     - {"success_rate"})
            and fast["sli"]["count"] >= policy.min_requests)
        qualify = self._objectives(policy, win, policy.qualify_window_s, now)
        healthy = (not qualify["failed"]
                   and qualify["sli"]["count"] >= policy.min_requests)
        st.last_eval = {
            "state": "breach" if breach else
                     "healthy" if healthy else "observing",
            "engine": label, "stable_engine": stable_label,
            "fast": fast, "slow": slow, "qualify": qualify["sli"],
        }
        in_cooldown = (now - st.last_decision_s
                       < self._cooldowns[policy.name])
        if breach:
            self.breaches += 1
            # rolling back to the engine we'd roll back TO is a no-op
            if in_cooldown or label == stable_label:
                return None
            return self._decide(st, "rollback", self._rollback, label,
                                stable_label, st.last_eval, now)
        if healthy and label != stable_label and not in_cooldown:
            return self._decide(st, "promote", self._promote, label,
                                stable_label, st.last_eval, now)
        return None

    def _decide(self, st: _PolicyState, action: str,
                actuate: Callable[[SLOPolicy], Any], label: str,
                stable_label: Optional[str], evidence: Dict[str, Any],
                now: float) -> Dict[str, Any]:
        policy = st.policy
        self._seq += 1
        seq = self._seq
        trace_id = f"slo-{policy.name}-{seq:04d}"
        try:
            result = actuate(policy)
            error = None
        except Exception as e:              # noqa: BLE001 — audit, continue
            result, error = None, f"{type(e).__name__}: {e}"
        decision = {
            "seq": seq, "trace_id": trace_id, "unix_time": time.time(),
            "policy": policy.name, "action": action, "alias": policy.alias,
            "engine": label, "stable_engine": stable_label,
            "error": error,
            "fast_burn": evidence["fast"]["burn_rate"],
            "slow_burn": evidence["slow"]["burn_rate"],
            "failed_objectives": sorted(set(evidence["fast"]["failed"])
                                        | set(evidence["slow"]["failed"])),
            "window_count": evidence["qualify"]["count"],
            "result": result if isinstance(result, dict) else None,
        }
        st.last_decision_s = now
        with self._lock:
            self._decisions.append(decision)
            del self._decisions[:-self.max_decisions]
            if error is None:
                if action == "promote":
                    self.promotions += 1
                else:
                    self.rollbacks += 1
        rec = self.recorder
        if rec is not None:
            try:       # an auditable, queryable trace per decision
                tr = rec.begin(trace_id, "slo")
                tr.event(action, alias=policy.alias, engine=label,
                         policy=policy.name,
                         fast_burn=decision["fast_burn"],
                         slow_burn=decision["slow_burn"],
                         failed=decision["failed_objectives"])
                tr.finish(status=500 if error else 200, error=error)
            except Exception:   # telemetry must never break actuation
                pass
        return decision

    # -- public ------------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation pass over every policy; returns the decisions
        it made (usually none)."""
        now = time.perf_counter() if now is None else now
        self.evaluations += 1
        out = []
        for st in self._states:
            try:
                d = self._evaluate_policy(st, now)
            except Exception as e:          # noqa: BLE001 — keep evaluating
                st.last_eval = {"state": "error",
                                "error": f"{type(e).__name__}: {e}"}
                d = None
            if d is not None:
                out.append(d)
        return out

    def decisions(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._decisions)

    def stats(self) -> Dict[str, Any]:
        """The /metrics ``slo`` section (ZERO_SLO schema, populated)."""
        with self._lock:
            return {"policies": len(self._states),
                    "evaluations": self.evaluations,
                    "decisions": len(self._decisions),
                    "promotions": self.promotions,
                    "rollbacks": self.rollbacks,
                    "breaches": self.breaches}

    def status(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """The GET /v1/slo payload: policies with their latest evaluation
        evidence, the decision audit log, and an SLI snapshot."""
        snap_window = window_s or max(
            [st.policy.fast_window_s for st in self._states] or [60.0])
        return {
            **self.stats(),
            "policies": [{**st.policy.to_dict(), "eval": dict(st.last_eval)}
                         for st in self._states],
            "decisions": self.decisions(),
            "sli": self.store.snapshot(snap_window),
        }

    # -- background loop ---------------------------------------------------

    def start(self) -> "SLOController":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="flexserve-slo",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:   # pragma: no cover — belt and braces
                pass
