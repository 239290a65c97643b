"""Deterministic fault injection for chaos drills: the port's copy of
``repro/core/faults.py`` (the port imports nothing of the JAX package).

A :class:`FaultInjector` holds a declarative schedule of
:class:`FaultSpec` entries and is threaded through the serving stack,
which calls :meth:`FaultInjector.fire` at named **sites** on the hot
path.  Each spec counts the hits it matches and acts on a deterministic
subset of them (``at``/``every``/``count``), so a chaos run is
reproducible from its config alone — no RNG, no wall-clock coupling on
the decision itself.

Sites wired in the port:

========================  ====================================================
``engine_step``           start of a decode tick's device work
                          (``raise`` poisons the batch — the driver fails
                          in-flight requests and keeps going)
``decode_tick``           top of every scheduler tick (``stall``/``slow``
                          sleep inside the driver loop — a wedged decode loop)
``prefill``               before a batched prefill forward (``raise``
                          simulates a prefill OOM)
``engine_install``        per-replica, after the engine is built but before
                          the alias repoint (crash-during-swap)
``checkpoint_load``       before ``ModelStore.load`` (corrupted checkpoint)
``socket_drop``           before each streamed chunk is written (connection
                          drop mid-stream)
``replica_kill``          polled by the replica health monitor (hard-kill a
                          replica at the n-th sweep)
========================  ====================================================

Counters are kept **per (spec, replica)**: a spec with ``replica: null``
that matches several replicas gives each replica its own independent
``at``/``every``/``count`` schedule.  Sites fired without a replica id
(``socket_drop``, ``checkpoint_load``) share one counter.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

__all__ = ["InjectedFault", "FaultSpec", "FaultInjector",
           "ZERO_FAULT_STATS"]

# schema-stable zero block for /metrics when no injector is configured
ZERO_FAULT_STATS: Mapping[str, Any] = {
    "enabled": False,
    "specs": 0,
    "fired_total": 0,
    "sites": {},
}

_ACTIONS = ("raise", "stall", "slow", "drop")


class InjectedFault(RuntimeError):
    """Raised at a fault site by an armed spec.

    A plain ``RuntimeError`` subclass so every existing failure path
    (driver ``_fail_in_flight``, lifecycle error mapping, stream
    teardown) handles it without special-casing — which is the point:
    injected faults must exercise the real error machinery.
    """

    def __init__(self, site: str, message: str = ""):
        self.site = site
        super().__init__(message or f"injected fault at site {site!r}")


@dataclass
class FaultSpec:
    """One line of a fault schedule.

    ``at`` is the 1-based hit index of the first firing, ``every`` the
    stride between firings after that, ``count`` the total number of
    firings (``0`` means unlimited).  ``action`` is ``raise`` (throw
    :class:`InjectedFault`), ``stall``/``slow`` (sleep ``delay_ms``
    inside the site), or ``drop`` (throw — sites that own a transport,
    e.g. the stream writer, translate it into a connection drop).
    ``replica`` restricts the spec to one replica id.
    """

    site: str
    action: str = "raise"
    at: int = 1
    every: int = 1
    count: int = 1
    delay_ms: float = 0.0
    replica: Optional[int] = None
    message: str = ""

    def __post_init__(self) -> None:
        if self.action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} "
                f"(expected one of {_ACTIONS})")
        if self.at < 1:
            raise ValueError(f"fault 'at' must be >= 1, got {self.at}")
        if self.every < 1:
            raise ValueError(
                f"fault 'every' must be >= 1, got {self.every}")


@dataclass
class _SpecState:
    spec: FaultSpec
    hits: Dict[Any, int] = field(default_factory=dict)
    fired: Dict[Any, int] = field(default_factory=dict)

    def fired_total(self) -> int:
        return sum(self.fired.values())


class FaultInjector:
    """Deterministic, thread-safe fault scheduler.

    ``fire(site, replica=...)`` advances every matching spec's counter
    and performs the due action (raise / sleep).  ``should(site, ...)``
    advances counters and *returns* the due spec instead of acting —
    for sites (like the health monitor's ``replica_kill``) where the
    caller owns the consequence.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self._lock = threading.Lock()
        self._states = [_SpecState(s) for s in specs]

    # -- construction ------------------------------------------------------

    @classmethod
    def from_config(cls, cfg: Union[Mapping[str, Any],
                                    Sequence[Mapping[str, Any]]]
                    ) -> "FaultInjector":
        """Build from ``{"faults": [...]}`` or a bare list of spec dicts."""
        if isinstance(cfg, Mapping):
            entries = cfg.get("faults", [])
        else:
            entries = cfg
        specs = []
        for e in entries:
            unknown = set(e) - {f for f in FaultSpec.__dataclass_fields__}
            if unknown:
                raise ValueError(
                    f"unknown fault spec field(s): {sorted(unknown)}")
            specs.append(FaultSpec(**e))
        return cls(specs)

    @classmethod
    def load(cls, source: Any) -> Optional["FaultInjector"]:
        """Coerce ``None`` / an injector / a config dict-or-list / a JSON
        file path into an injector (or ``None``)."""
        if source is None:
            return None
        if isinstance(source, FaultInjector):
            return source
        if isinstance(source, (Mapping, list, tuple)):
            return cls.from_config(source)
        with open(source, "r", encoding="utf-8") as fh:
            return cls.from_config(json.load(fh))

    # -- firing ------------------------------------------------------------

    def should(self, site: str,
               replica: Optional[int] = None) -> Optional[FaultSpec]:
        """Advance counters for one hit at ``site``; return the first due
        spec (its firing is recorded) or ``None``.  Never raises/sleeps."""
        due: Optional[FaultSpec] = None
        with self._lock:
            for st in self._states:
                s = st.spec
                if s.site != site:
                    continue
                if s.replica is not None and s.replica != replica:
                    continue
                key = replica if s.replica is None else s.replica
                hit = st.hits.get(key, 0) + 1
                st.hits[key] = hit
                if hit < s.at or (hit - s.at) % s.every != 0:
                    continue
                fired = st.fired.get(key, 0)
                if s.count and fired >= s.count:
                    continue
                st.fired[key] = fired + 1
                if due is None:
                    due = s
        return due

    def fire(self, site: str, replica: Optional[int] = None,
             **_ctx: Any) -> Optional[str]:
        """One hit at ``site``: raise, sleep, or pass through.  Returns the
        due spec's action (``None`` when nothing fired) so transport-owning
        sites can act on ``drop``."""
        spec = self.should(site, replica)
        if spec is None:
            return None
        if spec.action in ("stall", "slow"):
            if spec.delay_ms > 0:
                time.sleep(spec.delay_ms / 1e3)
            return spec.action
        raise InjectedFault(site, spec.message)

    def scoped(self, replica: int) -> "_ScopedFaults":
        """A view with ``replica`` pre-bound — handed to per-replica
        schedulers so core code never learns about replica ids."""
        return _ScopedFaults(self, replica)

    # -- accounting --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            sites: Dict[str, Dict[str, int]] = {}
            total = 0
            for st in self._states:
                f = st.fired_total()
                total += f
                agg = sites.setdefault(
                    st.spec.site, {"specs": 0, "hits": 0, "fired": 0})
                agg["specs"] += 1
                agg["hits"] += sum(st.hits.values())
                agg["fired"] += f
            return {
                "enabled": True,
                "specs": len(self._states),
                "fired_total": total,
                "sites": sites,
            }


class _ScopedFaults:
    """Replica-bound view over a shared :class:`FaultInjector`."""

    __slots__ = ("_inj", "_replica")

    def __init__(self, inj: FaultInjector, replica: int):
        self._inj = inj
        self._replica = replica

    def fire(self, site: str, **ctx: Any) -> Optional[str]:
        return self._inj.fire(site, replica=self._replica, **ctx)

    def should(self, site: str) -> Optional[FaultSpec]:
        return self._inj.should(site, replica=self._replica)

    def stats(self) -> Dict[str, Any]:
        return self._inj.stats()
