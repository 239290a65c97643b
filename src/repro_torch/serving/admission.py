"""Unified request plane: admission control, deadlines, and load shedding.

Every inference-plane request (/v1/infer, /v1/detect, /v1/generate) gets a
``RequestContext`` at the HTTP boundary — arrival time, absolute deadline,
priority class, client tag, trace id — which is threaded through the
coalescer, the continuous-batching scheduler, the generation service, and
the lifecycle manager's traffic accounting.  The layers below no longer
keep ad-hoc per-request bookkeeping; they read the context.

``AdmissionController`` is the overload policy in one place:

  * **Bounded queues** — each plane ("infer", "generate") admits at most
    its budget in cost units at a time.  Excess load is SHED at admission
    with a 429 + ``Retry-After`` instead of growing an unbounded queue
    until everyone's latency is ruined.  The infer plane costs ROWS (the
    thing that occupies device batches); the generate plane costs TOKENS
    — prompt length + requested ``max_new_tokens`` — because a decode
    request's hold on the device is proportional to its token footprint,
    not its prompt count: a single 100k-token request must not slip under
    a row-count budget as "1 unit" (``plane_budgets`` overrides the
    default ``max_queue`` per plane, in that plane's units).

  * **Cheapest-first rejection** — two priority classes.  ``bulk`` may
    only occupy ``bulk_fraction`` of a plane's budget, so under pressure
    bulk traffic sheds first while ``interactive`` still admits; an
    interactive request is refused only when the whole budget is in use.

  * **Deadlines** — a request past its deadline is dropped at the next
    hand-off (admission, coalescer group formation, scheduler admit)
    BEFORE it costs a forward pass, and returned as 504.  Misses are
    counted per stage.

  * **Retry-After** — computed per plane from the observed RELEASE rate
    (EWMA of the gap between budget releases, per cost unit) times the
    current backlog: the hint tracks how long this plane's backlog
    actually takes to drain on this host.  Release rate — not ticket
    lifetime — because a ticket's hold time includes its own queue wait
    (and a stream's ticket lives for the whole stream), which would
    wildly overstate drain time for mixed traffic.

The controller never queues anything itself — the coalescer and scheduler
keep their own queues — it meters what those queues are allowed to hold,
which keeps the policy testable without the machinery.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

PRIORITIES = ("interactive", "bulk")

_trace_counter = itertools.count(1)


class ShedError(RuntimeError):
    """Load shed at admission (HTTP 429).  Carries the Retry-After hint."""

    def __init__(self, message: str, retry_after_s: float = 0.5):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineError(RuntimeError):
    """Deadline exceeded before useful work was spent (HTTP 504)."""


@dataclass
class RequestContext:
    """Per-request facts every layer of the request plane can read.

    ``arrival_s`` / ``deadline_s`` are ``time.perf_counter`` values (the
    clock every queue-side timestamp in this codebase already uses), so
    ``expired`` is one comparison with no clock conversions on hot paths.
    """

    arrival_s: float
    deadline_s: Optional[float] = None
    priority: str = "interactive"
    client: Optional[str] = None
    trace_id: str = ""
    # live telemetry.Trace attached by the server's flight recorder (None
    # when tracing is off); planes read it duck-typed and guard on None
    trace: Optional[Any] = None

    def remaining_s(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.deadline_s - (now if now is not None
                                  else time.perf_counter())

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline_s is not None
                and (now if now is not None
                     else time.perf_counter()) >= self.deadline_s)

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"priority": self.priority,
                               "trace_id": self.trace_id}
        if self.client:
            out["client"] = self.client
        rem = self.remaining_s()
        if rem is not None:
            out["deadline_remaining_ms"] = 1e3 * rem
        return out


def make_context(req: Dict[str, Any],
                 headers: Optional[Dict[str, str]] = None, *,
                 arrival_s: Optional[float] = None,
                 default_deadline_ms: Optional[float] = None
                 ) -> RequestContext:
    """Build a context from a parsed request body (and the already-lowered
    ``x-flexserve-*`` headers the HTTP layer captured).  Body fields win
    over headers; ``default_deadline_ms`` applies when neither names one.

    Raises ValueError on a malformed priority/deadline (the route layer
    maps it to 400).
    """
    headers = headers or {}
    arrival = arrival_s if arrival_s is not None else time.perf_counter()
    priority = req.get("priority", headers.get("x-flexserve-priority",
                                               "interactive"))
    if priority not in PRIORITIES:
        raise ValueError(f"'priority' must be one of {PRIORITIES}, "
                         f"got {priority!r}")
    raw = req.get("deadline_ms", headers.get("x-flexserve-deadline-ms"))
    if raw is None:
        deadline_ms = default_deadline_ms
    else:
        try:
            deadline_ms = float(raw)
        except (TypeError, ValueError):
            raise ValueError(f"'deadline_ms' must be a number, "
                             f"got {raw!r}") from None
        if deadline_ms <= 0:
            raise ValueError("'deadline_ms' must be > 0")
    deadline = (arrival + deadline_ms / 1e3
                if deadline_ms is not None else None)
    trace = str(req.get("trace_id", headers.get("x-request-id", ""))
                or f"req-{next(_trace_counter):06d}")
    client = req.get("client", headers.get("x-flexserve-client"))
    return RequestContext(arrival, deadline, priority,
                          str(client) if client is not None else None, trace)


@dataclass
class Ticket:
    """One admitted request's hold on a plane's budget; released when the
    request leaves the plane (finished, shed, or errored).  Idempotent
    under concurrent callers — a disconnect can race the terminal event,
    and a double decrement would silently widen the queue bound."""

    controller: "AdmissionController"
    plane: str
    priority: str
    cost: int
    admitted_s: float
    client: Optional[str] = None       # quota tag (None: quotas disabled)
    _released: bool = field(default=False)

    def release(self) -> None:
        self.controller._release(self)


class AdmissionController:
    """Bounded-queue admission with priority-aware shedding (see module
    docstring).  ``max_queue`` is in COST units (input rows / prompts),
    the thing that actually occupies device batches — a 16-row request
    takes 16x the budget of a 1-row request."""

    _EWMA_ALPHA = 0.2

    MAX_CLIENT_TAGS = 1024        # distinct tags tracked per plane

    def __init__(self, *, max_queue: int = 64, bulk_fraction: float = 0.5,
                 default_deadline_ms: Optional[float] = None,
                 min_retry_after_s: float = 0.05,
                 plane_budgets: Optional[Dict[str, int]] = None,
                 client_weights: Optional[Dict[str, float]] = None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.max_queue = max_queue
        self.bulk_fraction = bulk_fraction
        self.bulk_max = max(1, int(max_queue * bulk_fraction))
        # per-client quotas: ACTIVE only when a weight map is given (even
        # an empty one — unknown tags then weigh 1.0).  While several tags
        # hold budget, each is capped at its weighted share; a lone tag
        # still gets the whole plane, and any tag always gets at least
        # one request in flight (no hard starvation of big requests).
        self.client_weights = (dict(client_weights)
                               if client_weights is not None else None)
        # per-plane budget overrides, each in ITS plane's cost units
        # (e.g. {"generate": tokens}); planes not named use max_queue
        self.plane_budgets = dict(plane_budgets or {})
        for name, budget in self.plane_budgets.items():
            if budget < 1:
                raise ValueError(f"plane budget {name!r} must be >= 1")
        self.default_deadline_ms = default_deadline_ms
        self.min_retry_after_s = min_retry_after_s
        self._lock = threading.Lock()
        self._planes: Dict[str, Dict[str, Any]] = {}

    def budget_for(self, plane: str) -> int:
        return self.plane_budgets.get(plane, self.max_queue)

    def _bulk_max_for(self, plane: str) -> int:
        if plane in self.plane_budgets:
            return max(1, int(self.plane_budgets[plane]
                              * self.bulk_fraction))
        return self.bulk_max

    # --- context ----------------------------------------------------------------

    def context(self, req: Dict[str, Any],
                headers: Optional[Dict[str, str]] = None, *,
                arrival_s: Optional[float] = None) -> RequestContext:
        return make_context(req, headers, arrival_s=arrival_s,
                            default_deadline_ms=self.default_deadline_ms)

    # --- admission --------------------------------------------------------------

    def _plane(self, plane: str) -> Dict[str, Any]:
        st = self._planes.get(plane)
        if st is None:
            st = self._planes[plane] = {
                "depth": {p: 0 for p in PRIORITIES},
                "high_water": 0,
                "admitted": {p: 0 for p in PRIORITIES},
                "shed": {p: 0 for p in PRIORITIES},
                "deadline_miss": {},
                "last_release_s": None,
                "ewma_release_gap_s": None,   # per cost unit
                "clients": {},                # tag -> cost/admitted/shed
            }
        return st

    def _client(self, st: Dict[str, Any],
                tag: str) -> "tuple[str, Dict[str, Any]]":
        """(possibly folded tag, its entry) — unseen tags past the cap
        fold into ``"_overflow"`` so tag churn cannot grow memory."""
        clients = st["clients"]
        ent = clients.get(tag)
        if ent is None:
            if len(clients) >= self.MAX_CLIENT_TAGS:
                tag = "_overflow"
                ent = clients.get(tag)
                if ent is not None:
                    return tag, ent
            ent = clients[tag] = {"cost": 0, "admitted": 0, "shed": 0}
        return tag, ent

    def admit(self, plane: str, ctx: RequestContext,
              cost: int = 1) -> Ticket:
        """Admit ``cost`` units into ``plane`` or raise (504 if the request
        arrived already expired, 429 if the plane's budget is full)."""
        now = time.perf_counter()
        cost = max(1, int(cost))
        tr = ctx.trace
        with self._lock:
            st = self._plane(plane)
            if ctx.expired(now):
                miss = st["deadline_miss"]
                miss["admission"] = miss.get("admission", 0) + 1
                if tr is not None:
                    tr.event("deadline_drop", t=now, stage="admission",
                             plane=plane)
                raise DeadlineError(
                    f"deadline exceeded before admission "
                    f"({ctx.trace_id or 'request'})")
            depth = sum(st["depth"].values())
            budget = self.budget_for(plane)
            # bulk is capped at its OWN occupancy share (not total depth:
            # interactive-only load must not starve bulk out of a plane
            # with free budget), and everyone is capped at the total.
            over = depth + cost > budget
            if ctx.priority == "bulk":
                over = over or (st["depth"]["bulk"] + cost
                                > self._bulk_max_for(plane))
            # a single over-budget request still admits into an EMPTY
            # plane (otherwise it could never run at all)
            if over and depth > 0:
                st["shed"][ctx.priority] += 1
                retry = self._retry_after_locked(st, depth + cost)
                if tr is not None:
                    tr.event("shed", t=now, plane=plane, cost=cost,
                             depth=depth, budget=budget,
                             reason="queue_full",
                             retry_after_s=round(retry, 3))
                raise ShedError(
                    f"{plane} queue full "
                    f"({depth}/{budget} units, "
                    f"priority={ctx.priority})",
                    retry_after_s=retry)
            tag = None
            if self.client_weights is not None:
                tag, ent = self._client(st, ctx.client or "_untagged")
                # weighted-share quota: enforced only while OTHER tags
                # hold budget (a lone tag gets the whole plane), and a
                # tag holding nothing always admits one request
                holders = [t for t, e in st["clients"].items()
                           if e["cost"] > 0 and t != tag]
                if holders and ent["cost"] > 0:
                    w = self.client_weights.get(tag, 1.0)
                    wsum = w + sum(self.client_weights.get(t, 1.0)
                                   for t in holders)
                    share = budget * w / wsum
                    if ent["cost"] + cost > share:
                        ent["shed"] += 1
                        st["shed"][ctx.priority] += 1
                        retry = self._retry_after_locked(
                            st, ent["cost"] + cost)
                        if tr is not None:
                            tr.event("shed", t=now, plane=plane,
                                     cost=cost, reason="client_quota",
                                     client=tag, held=ent["cost"],
                                     share=round(share, 1),
                                     retry_after_s=round(retry, 3))
                        raise ShedError(
                            f"{plane} quota for client {tag!r} full "
                            f"({ent['cost']}/{share:.0f} of "
                            f"{budget} units)",
                            retry_after_s=retry)
                ent["cost"] += cost
                ent["admitted"] += 1
            st["depth"][ctx.priority] += cost
            st["admitted"][ctx.priority] += 1
            st["high_water"] = max(st["high_water"], depth + cost)
        if tr is not None:
            tr.event("admitted", t=now, plane=plane, cost=cost,
                     depth=depth + cost, budget=budget)
        return Ticket(self, plane, ctx.priority, cost, now, client=tag)

    def _release(self, ticket: Ticket) -> None:
        now = time.perf_counter()
        with self._lock:
            if ticket._released:          # idempotent under the lock:
                return                    # cancel can race the terminal
            ticket._released = True
            st = self._plane(ticket.plane)
            st["depth"][ticket.priority] = max(
                0, st["depth"][ticket.priority] - ticket.cost)
            if ticket.client is not None:
                ent = st["clients"].get(ticket.client)
                if ent is not None:
                    ent["cost"] = max(0, ent["cost"] - ticket.cost)
            # drain-rate estimate: gap between consecutive releases,
            # normalized per cost unit released — sampled only while the
            # plane is still BUSY, so the gap measures service, not the
            # idle time since the last burst (an overnight gap would
            # poison the hint for every release that follows).  Hints
            # only need to be accurate under load, and under load the
            # plane is busy at release time.
            last = st["last_release_s"]
            st["last_release_s"] = now
            if last is not None and sum(st["depth"].values()) > 0:
                gap_unit = (now - last) / max(ticket.cost, 1)
                prev = st["ewma_release_gap_s"]
                st["ewma_release_gap_s"] = (
                    gap_unit if prev is None else
                    (1 - self._EWMA_ALPHA) * prev
                    + self._EWMA_ALPHA * gap_unit)

    MAX_RETRY_AFTER_S = 60.0      # never tell a client to go away for days

    def _retry_after_locked(self, st: Dict[str, Any],
                            backlog_units: int) -> float:
        gap = st["ewma_release_gap_s"]
        unit = gap if gap is not None else 0.01
        return min(max(self.min_retry_after_s, unit * backlog_units),
                   self.MAX_RETRY_AFTER_S)

    # --- deadline hand-offs -----------------------------------------------------

    def deadline_miss(self, plane: str, stage: str) -> None:
        """Record a drop at a downstream hand-off (coalescer group
        formation, scheduler admit, decode tick)."""
        with self._lock:
            miss = self._plane(plane)["deadline_miss"]
            miss[stage] = miss.get(stage, 0) + 1

    # --- observability ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            planes = {
                name: {
                    "depth": dict(st["depth"]),
                    "depth_total": sum(st["depth"].values()),
                    "budget": self.budget_for(name),
                    "high_water": st["high_water"],
                    "admitted": dict(st["admitted"]),
                    "shed": dict(st["shed"]),
                    "deadline_miss": dict(st["deadline_miss"]),
                    "ewma_release_gap_ms": (
                        1e3 * st["ewma_release_gap_s"]
                        if st["ewma_release_gap_s"] is not None else None),
                    **({"clients": {t: dict(e)
                                    for t, e in st["clients"].items()}}
                       if self.client_weights is not None else {}),
                }
                for name, st in self._planes.items()}
            return {
                "max_queue": self.max_queue,
                "bulk_max": self.bulk_max,
                "default_deadline_ms": self.default_deadline_ms,
                "quotas_enabled": self.client_weights is not None,
                "planes": planes,
            }
