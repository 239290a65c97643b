"""Model lifecycle manager: hot load/unload/swap of versioned models.  The
port of ``repro/serving/lifecycle.py``.

``ModelManager`` sits between the ``ModelStore`` (durable,
versioned, provenance-manifested checkpoints) and the live serving stack
(``ModelRegistry`` + per-alias ``Ensemble``s) and performs membership
changes WITHOUT dropping traffic:

  load:   restore + hash-verify the version onto the device off the hot
          path, register it, build the new ensemble state, run each of its
          batch buckets once against a captured example batch (warm: the
          kernel libraries load and the allocator grows BEFORE the flip),
          then atomically publish the state and drain in-flight coalesced
          batches on the old one.
  unload: retire a version (refused while any alias still serves it) or a
          whole member; the manager then holds no reference to its
          tensors, so the device memory they held is released.
  rollback: swap an alias back to the previously active version.

Version ALIASES ("stable", "canary", ...) each own a membership map and an
ensemble; ``/v1/infer``/``/v1/detect`` target one per request, so a canary
version takes real traffic next to stable — sharing the param arrays of
every member the two aliases have in common.

GENERATION ENGINES ride the same lifecycle: with a ``GenerationService``
attached, ``load_engine`` materializes a store version (restore + hash
verify, like any member), wraps it in an ``InferenceEngine``, and
hot-swaps it under an engine alias — new decode requests land on the new
engine while in-flight streams drain on the old one — with
``rollback_engine`` returning an alias to its previous version.  ``gc``
applies a keep-last-N retention policy to the store, never deleting a
version any serving alias (ensemble or engine, active or rollback
target) still references.  ``load_engine(..., draft=...)`` serves a
speculative pair (a ``SpeculativeEngine`` over two store versions) as ONE
engine entry, so promote/demote/rollback move the draft with its target
and gc protects both checkpoints.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.engine import InferenceEngine, SpeculativeEngine
from repro_torch.core.ensemble import Ensemble, EnsembleMember
from repro_torch.core.faults import FaultInjector, InjectedFault
from repro_torch.core.memory import MemoryLedger
from repro_torch.core.registry import ModelRegistry
from repro_torch.kernels.common import resolve_device
from repro_torch.models.build import build_model
from repro_torch.serving.modelstore import ModelStore


class LifecycleError(RuntimeError):
    """Admin-plane failure (unknown version, conflict, empty ensemble)."""


def default_factory(manifest: Dict[str, Any]):
    """manifest -> (Model, apply_fn, num_classes) via the port's configs.

    The manifest's ``config`` names the arch; ``reduced`` (default True)
    selects the smoke-size variant; ``num_classes`` sizes the
    classification readout (last-position logits), matching launch/serve.
    ``num_layers`` (optional) truncates the stack — how a published
    checkpoint records a depth cut.
    """
    cfg = get_config(manifest["config"])
    if manifest.get("reduced", True):
        cfg = reduce_for_smoke(cfg)
    if manifest.get("num_layers"):
        cfg = dataclasses.replace(cfg, num_layers=int(manifest["num_layers"]))
    model = build_model(cfg)
    num_classes = int(manifest.get("num_classes", 16))

    def apply(p, batch, _m=model, _c=num_classes):
        return _m.forward(p, batch)[:, -1, :_c]

    return model, apply, num_classes


def default_engine_factory(manifest: Dict[str, Any], model,
                           params) -> InferenceEngine:
    """(manifest, Model, params) -> InferenceEngine for the decode plane.

    ``max_len`` / ``max_batch`` come from the manifest when the publisher
    recorded them, so an engine version carries its own serving shape."""
    return InferenceEngine(model, params,
                           max_len=int(manifest.get("max_len", 256)),
                           max_batch=int(manifest.get("max_batch", 8)))


class ModelManager:
    """Coordinates store <-> registry <-> per-alias ensembles.

    Admin operations (load/unload/rollback) serialize on one lock and do
    all expensive work (restore, hash verify, warm) before the atomic
    ensemble swap, so the hot path never waits on the admin plane.
    Versions are restored onto ``device`` (CUDA unless given).
    """

    def __init__(self, store: ModelStore,
                 registry: Optional[ModelRegistry] = None, *,
                 factory: Callable[[Dict[str, Any]], Tuple[Any, Any, int]]
                 = default_factory,
                 engine_factory: Callable[[Dict[str, Any], Any, Any],
                                          InferenceEngine]
                 = default_engine_factory,
                 max_batch: int = 8,
                 class_names: Optional[List[str]] = None,
                 default_alias: str = "stable",
                 drain_timeout_s: float = 30.0,
                 faults: Optional[FaultInjector] = None,
                 device=None):
        self.device = resolve_device(device)
        self.faults = faults
        self.store = store
        self.registry = registry or ModelRegistry()
        self.max_batch = max_batch
        self.class_names = class_names
        self.default_alias = default_alias
        self.drain_timeout_s = drain_timeout_s
        self._factory = factory
        self._engine_factory = engine_factory
        self.generation = None          # attach_generation() wires this
        self._engine_active: Dict[str, Tuple[str, int]] = {}
        self._engine_previous: Dict[str, Tuple[str, int]] = {}
        # speculative pairs: alias -> (draft name, draft version).  The
        # pair serves as ONE entry, so promote/demote/rollback move the
        # draft with its target and gc protects both checkpoints.
        self._engine_drafts: Dict[str, Tuple[str, int]] = {}
        self._engine_prev_drafts: Dict[str, Optional[Tuple[str, int]]] = {}
        self._admin_lock = threading.RLock()
        # alias -> {member name -> active version}; maps are replaced
        # wholesale under the admin lock, so hot-path readers always see a
        # consistent snapshot without locking.
        self._active: Dict[str, Dict[str, int]] = {}
        self._ensembles: Dict[str, Ensemble] = {}
        self._previous: Dict[Tuple[str, str], int] = {}
        self._warm_example: Optional[Dict[str, np.ndarray]] = None
        self._stats_lock = threading.Lock()
        self._counters = {"loads": 0, "unloads": 0, "swaps": 0,
                          "rollbacks": 0, "engine_loads": 0,
                          "engine_rollbacks": 0, "engine_promotes": 0,
                          "engine_demotes": 0, "gc_runs": 0}
        self._warm_total_s = 0.0
        self._last_warm_s = 0.0
        self._version_traffic: Dict[str, Dict[str, int]] = {}

    # --- hot path -------------------------------------------------------------

    @property
    def ready(self) -> bool:
        return self.default_alias in self._ensembles

    def aliases(self) -> List[str]:
        return sorted(self._ensembles)

    def ensemble_for(self, alias: Optional[Hashable] = None) -> Ensemble:
        alias = alias or self.default_alias
        try:
            return self._ensembles[alias]
        except KeyError:
            raise LifecycleError(
                f"no alias {alias!r}; available: {self.aliases()}") from None

    def forward(self, batch: Dict[str, np.ndarray],
                alias: Optional[Hashable] = None,
                ctxs: Optional[List[Any]] = None):
        """Route one (possibly coalesced) batch to an alias's ensemble.

        ``ctxs`` — the RequestContexts the coalescer merged into this
        batch — feeds per-version traffic accounting with a priority
        split, so a canary's interactive-vs-bulk exposure is visible (the
        signal canary auto-promotion will gate on)."""
        alias = alias or self.default_alias
        ens = self.ensemble_for(alias)
        if self._warm_example is None:
            # remember a one-row example of real traffic: future loads
            # warm their buckets against this shape
            self._warm_example = {k: np.asarray(v)[:1].copy()
                                  for k, v in batch.items()}
        active = self._active.get(alias, {})
        rows = next(iter(batch.values())).shape[0]
        interactive = sum(1 for c in (ctxs or [])
                          if getattr(c, "priority", None) != "bulk")
        bulk = len(ctxs or []) - interactive
        if ctxs and active:
            # composite ensemble version label, so infer-plane requests
            # attribute per version like generate-plane ones do
            label = ",".join(f"{n}@v{v}" for n, v in sorted(active.items()))
            for c in ctxs:
                tr = getattr(c, "trace", None)
                if tr is not None and hasattr(tr, "annotate"):
                    tr.annotate("version", label)
        with self._stats_lock:
            for name, version in active.items():
                t = self._version_traffic.setdefault(
                    f"{name}@v{version}",
                    {"batches": 0, "rows": 0,
                     "interactive_requests": 0, "bulk_requests": 0})
                t["batches"] += 1
                t["rows"] += rows
                t["interactive_requests"] += interactive
                t["bulk_requests"] += bulk
        return ens.forward(batch)

    # --- admin plane ----------------------------------------------------------

    def load(self, name: str, version: Optional[int] = None, *,
             alias: Optional[str] = None, warm: bool = True,
             warm_example: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Load a store version and hot-swap it into an alias's ensemble."""
        alias = alias or self.default_alias
        with self._admin_lock:
            if version is None:
                version = self.store.latest_version(name)
                if version is None:
                    raise LifecycleError(
                        f"store has no published versions of {name!r}")
            manifest = self.store.manifest(name, version)   # raises StoreError
            rm = self._materialize(name, version, manifest)
            base = self._active.get(alias,
                                    self._active.get(self.default_alias, {}))
            old_version = self._active.get(alias, {}).get(name)
            new_map = dict(base)
            new_map[name] = version
            swap = self._apply_membership(
                alias, new_map, warm=warm, warm_example=warm_example)
            if old_version is not None and old_version != version:
                self._previous[(alias, name)] = old_version
            with self._stats_lock:
                self._counters["loads"] += 1
            return {"name": name, "version": version, "alias": alias,
                    "previous_version": old_version,
                    "manifest": manifest, **swap}

    def unload(self, name: str, version: Optional[int] = None) -> Dict[str, Any]:
        """Retire a loaded version, or the whole member when version is None.

        A version still active in any alias is refused (conflict) — swap or
        roll the alias first.  Removing the last member of an ensemble is
        refused for the same reason: the endpoint must keep serving.
        """
        with self._admin_lock:
            if version is not None:
                holders = [a for a, m in self._active.items()
                           if m.get(name) == version]
                holders += [f"engine:{a}"
                            for a, nv in self._engine_active.items()
                            if nv == (name, version)]
                if holders:
                    raise LifecycleError(
                        f"{name} v{version} is active in alias(es) "
                        f"{holders}; load another version or unload the "
                        f"member")
                self.registry.unregister(name, version)   # KeyError if absent
                with self._stats_lock:
                    self._counters["unloads"] += 1
                return {"name": name, "version": version, "unloaded": True}
            # whole-member retirement, every alias — validate every alias
            # BEFORE mutating any, so a refused unload changes nothing
            if not any(name in m for m in self._active.values()):
                raise LifecycleError(f"{name!r} is not an ensemble member")
            new_maps = {}
            for a, members in self._active.items():
                if name not in members:
                    continue
                new_map = {k: v for k, v in members.items() if k != name}
                if not new_map:
                    raise LifecycleError(
                        f"unloading {name!r} would empty alias {a!r}")
                new_maps[a] = new_map
            swaps = {a: self._apply_membership(a, new_map, warm=False)
                     for a, new_map in new_maps.items()}
            self.registry.unregister(name)
            self._previous = {k: v for k, v in self._previous.items()
                              if k[1] != name}
            with self._stats_lock:
                self._counters["unloads"] += 1
            return {"name": name, "unloaded": True, "aliases": swaps}

    def rollback(self, name: str, *,
                 alias: Optional[str] = None, warm: bool = True) -> Dict[str, Any]:
        """Swap an alias back to the member's previously active version."""
        alias = alias or self.default_alias
        with self._admin_lock:
            prev = self._previous.get((alias, name))
            if prev is None:
                raise LifecycleError(
                    f"no previous version of {name!r} recorded for alias "
                    f"{alias!r}")
            result = self.load(name, prev, alias=alias, warm=warm)
            with self._stats_lock:
                self._counters["rollbacks"] += 1
                self._counters["loads"] -= 1    # it was a rollback, not a load
            result["rolled_back_to"] = prev
            return result

    # --- generation-engine plane ----------------------------------------------

    def attach_generation(self, service) -> Any:
        """Wire a ``GenerationService``; engine versions then flow through
        this manager (load_engine / rollback_engine), under the manager's
        drain budget."""
        service.drain_timeout_s = self.drain_timeout_s
        self.generation = service
        return service

    def _require_generation(self):
        if self.generation is None:
            raise LifecycleError(
                "no generation service attached to this manager; "
                "engine lifecycle needs a scheduler-backed endpoint")
        return self.generation

    def load_engine(self, name: str, version: Optional[int] = None, *,
                    alias: Optional[str] = None,
                    warm: bool = True,
                    draft: Optional[str] = None,
                    draft_version: Optional[int] = None,
                    max_window: int = 4) -> Dict[str, Any]:
        """Materialize a store version (restore + hash verify) as an
        InferenceEngine and hot-swap it under an engine alias.  In-flight
        decode streams drain on the displaced engine before it is closed;
        new requests land on the new engine immediately.  ``warm``
        (default) runs the new engine's decode data path once (prefill
        buckets, sampler, decode tick) BEFORE the alias flips, so the swap
        never stalls live streams on kernel builds or allocator growth
        (mirrors the model plane's warm-before-publish).

        ``draft`` names a second store model to materialize as the
        proposer of a speculative pair: both checkpoints restore + hash
        verify, and the alias serves ONE ``SpeculativeEngine`` wrapping
        them — so canary/promote/demote/rollback move the pair as a unit
        and neither checkpoint is gc-eligible while the alias lives.
        ``max_window`` bounds the per-tick proposal window."""
        gen = self._require_generation()
        alias = alias or self.default_alias
        with self._admin_lock:
            if version is None:
                version = self.store.latest_version(name)
                if version is None:
                    raise LifecycleError(
                        f"store has no published versions of {name!r}")
            manifest = self.store.manifest(name, version)  # raises StoreError
            rm = self._materialize(name, version, manifest)
            engine = self._engine_factory(manifest, rm.model, rm.params)
            draft_nv: Optional[Tuple[str, int]] = None
            if draft is not None:
                if draft_version is None:
                    draft_version = self.store.latest_version(draft)
                    if draft_version is None:
                        raise LifecycleError(
                            f"store has no published versions of draft "
                            f"{draft!r}")
                dmanifest = self.store.manifest(draft, draft_version)
                drm = self._materialize(draft, draft_version, dmanifest)
                draft_engine = self._engine_factory(dmanifest, drm.model,
                                                    drm.params)
                try:
                    engine = SpeculativeEngine(engine, draft_engine,
                                               max_window=max_window)
                except ValueError as e:
                    raise LifecycleError(
                        f"incompatible speculative pair {name} v{version} "
                        f"+ {draft} v{draft_version}: {e}") from None
                draft_nv = (draft, draft_version)
            swap = gen.install(name, version, engine, alias=alias,
                               warm=warm)
            old = self._engine_active.get(alias)
            old_draft = self._engine_drafts.get(alias)
            self._engine_active[alias] = (name, version)
            if draft_nv is not None:
                self._engine_drafts[alias] = draft_nv
            else:
                self._engine_drafts.pop(alias, None)
            if old is not None and old != (name, version):
                self._engine_previous[alias] = old
                self._engine_prev_drafts[alias] = old_draft
            with self._stats_lock:
                self._counters["engine_loads"] += 1
            return {"name": name, "version": version,
                    "manifest": manifest,
                    "speculative": draft_nv is not None,
                    "draft": (f"{draft_nv[0]}@v{draft_nv[1]}"
                              if draft_nv is not None else None),
                    **swap}

    def rollback_engine(self, name: Optional[str] = None, *,
                        alias: Optional[str] = None,
                        warm: bool = True) -> Dict[str, Any]:
        """Swap an engine alias back to its previously active version."""
        alias = alias or self.default_alias
        with self._admin_lock:
            prev = self._engine_previous.get(alias)
            if prev is None:
                raise LifecycleError(
                    f"no previous engine recorded for alias {alias!r}")
            if name is not None and prev[0] != name:
                raise LifecycleError(
                    f"alias {alias!r} previously served engine "
                    f"{prev[0]!r} v{prev[1]}, not {name!r}")
            prev_draft = self._engine_prev_drafts.get(alias)
            result = self.load_engine(
                prev[0], prev[1], alias=alias, warm=warm,
                draft=prev_draft[0] if prev_draft is not None else None,
                draft_version=(prev_draft[1] if prev_draft is not None
                               else None))
            with self._stats_lock:
                self._counters["engine_rollbacks"] += 1
                self._counters["engine_loads"] -= 1   # rollback, not a load
            result["rolled_back_to"] = prev[1]
            return result

    def engine_version_label(self, alias: Optional[str] = None
                             ) -> Optional[str]:
        """``"name@vN"`` currently served under an engine alias, or None —
        the SLO controller's resolve callback."""
        nv = self._engine_active.get(alias or self.default_alias)
        return f"{nv[0]}@v{nv[1]}" if nv is not None else None

    def promote_engine(self, alias: str = "canary", *,
                       to_alias: Optional[str] = None) -> Dict[str, Any]:
        """Make ``alias``'s engine the ``to_alias`` (default: stable)
        engine — canary promotion.  A pointer flip, not a reload: both
        aliases share the already-warm live entry, so promotion costs no
        warm-up and truncates nothing (the displaced stable engine drains
        in-flight streams before closing).  The displaced version is
        recorded as ``to_alias``'s rollback target."""
        gen = self._require_generation()
        to_alias = to_alias or self.default_alias
        with self._admin_lock:
            src = self._engine_active.get(alias)
            if src is None:
                raise LifecycleError(
                    f"no engine under alias {alias!r} to promote")
            swap = gen.repoint(alias, to_alias)
            old = self._engine_active.get(to_alias)
            old_draft = self._engine_drafts.get(to_alias)
            self._engine_active[to_alias] = src
            src_draft = self._engine_drafts.get(alias)
            if src_draft is not None:
                self._engine_drafts[to_alias] = src_draft
            else:
                self._engine_drafts.pop(to_alias, None)
            if old is not None and old != src:
                self._engine_previous[to_alias] = old
                self._engine_prev_drafts[to_alias] = old_draft
            with self._stats_lock:
                self._counters["engine_promotes"] += 1
            return {"name": src[0], "version": src[1], "from_alias": alias,
                    "promoted": swap.get("changed", True), **swap}

    def demote_engine(self, alias: str = "canary", *,
                      to_alias: Optional[str] = None) -> Dict[str, Any]:
        """Point a misbehaving ``alias`` back at ``to_alias``'s (default:
        stable's) engine — canary auto-rollback.  The breaching engine
        drains its in-flight streams and closes once no alias references
        it; canary traffic lands on the stable engine immediately."""
        gen = self._require_generation()
        to_alias = to_alias or self.default_alias
        with self._admin_lock:
            src = self._engine_active.get(to_alias)
            if src is None:
                raise LifecycleError(
                    f"no engine under alias {to_alias!r} to demote "
                    f"{alias!r} onto")
            swap = gen.repoint(to_alias, alias)
            old = self._engine_active.get(alias)
            old_draft = self._engine_drafts.get(alias)
            self._engine_active[alias] = src
            src_draft = self._engine_drafts.get(to_alias)
            if src_draft is not None:
                self._engine_drafts[alias] = src_draft
            else:
                self._engine_drafts.pop(alias, None)
            if old is not None and old != src:
                self._engine_previous[alias] = old
                self._engine_prev_drafts[alias] = old_draft
            with self._stats_lock:
                self._counters["engine_demotes"] += 1
            return {"name": src[0], "version": src[1],
                    "demoted_from": f"{old[0]}@v{old[1]}" if old else None,
                    **swap}

    # --- retention GC ---------------------------------------------------------

    def gc(self, name: str, keep_last_n: int) -> Dict[str, Any]:
        """Apply keep-last-N retention to ``name``'s store versions.
        Versions referenced by ANY serving alias — ensemble or engine,
        active or recorded as a rollback target — are never deleted."""
        with self._admin_lock:
            protected = {m[name] for m in self._active.values()
                         if name in m}
            protected |= {v for (a, n), v in self._previous.items()
                          if n == name}
            protected |= {v for n, v in self._engine_active.values()
                          if n == name}
            protected |= {v for n, v in self._engine_previous.values()
                          if n == name}
            protected |= {v for n, v in self._engine_drafts.values()
                          if n == name}
            protected |= {nv[1] for nv in self._engine_prev_drafts.values()
                          if nv is not None and nv[0] == name}
            result = self.store.gc(name, keep_last_n, protected=protected)
            with self._stats_lock:
                self._counters["gc_runs"] += 1
            return result

    def bootstrap(self, names: Optional[List[str]] = None, *,
                  warm_example: Optional[Dict[str, Any]] = None) -> "ModelManager":
        """Load the latest store version of every named model (default: all
        models in the store) into the default alias — endpoint startup."""
        names = names if names is not None else self.store.names()
        if not names:
            raise LifecycleError("model store is empty; publish versions "
                                 "before serving from it")
        for name in names:
            self.load(name, alias=self.default_alias,
                      warm=warm_example is not None,
                      warm_example=warm_example)
        return self

    # --- internals ------------------------------------------------------------

    def _materialize(self, name: str, version: int,
                     manifest: Dict[str, Any]):
        """Restore+verify a version into the registry (idempotent)."""
        try:
            return self.registry.get(name, version)
        except KeyError:
            pass
        model, apply_fn, num_classes = self._factory(manifest)
        # keys, shapes and dtypes only: meta tensors, no throwaway init
        like = model.like()
        if self.faults is not None:
            # "checkpoint_load": a corrupted/unreadable checkpoint —
            # surfaces like any store failure, BEFORE anything publishes
            try:
                self.faults.fire("checkpoint_load", name=name,
                                 version=version)
            except InjectedFault as e:
                raise LifecycleError(
                    f"checkpoint load failed for {name} v{version}: {e}"
                ) from e
        params, manifest = self.store.load(name, version, like,
                                           device=self.device)
        return self.registry.register(
            name, model, params, version=version,
            param_hash=manifest["param_hash"], apply=apply_fn,
            num_classes=num_classes)

    def _members_for(self, membership: Dict[str, int]) -> List[EnsembleMember]:
        members = []
        for name in sorted(membership):
            rm = self.registry.get(name, membership[name])
            members.append(EnsembleMember(
                name, rm.meta["apply"], rm.params,
                rm.meta.get("num_classes", 0)))
        return members

    def _apply_membership(self, alias: str, membership: Dict[str, int], *,
                          warm: bool,
                          warm_example: Optional[Dict[str, Any]] = None
                          ) -> Dict[str, Any]:
        members = self._members_for(membership)
        example = warm_example if warm_example is not None \
            else self._warm_example
        warm_batch = example if (warm and example is not None) else None
        ens = self._ensembles.get(alias)
        if ens is None:
            ens = Ensemble(members, max_batch=self.max_batch,
                           class_names=self.class_names)
            warm_s = ens.warm(warm_batch) if warm_batch is not None else 0.0
            swap = {"warm_s": warm_s, "drained": True,
                    "members": [m.name for m in members]}
            self._ensembles[alias] = ens
        else:
            swap = ens.set_members(members, warm_batch=warm_batch,
                                   drain_timeout=self.drain_timeout_s)
        self._active[alias] = membership
        with self._stats_lock:
            self._counters["swaps"] += 1
            self._warm_total_s += swap["warm_s"]
            self._last_warm_s = swap["warm_s"]
        return {"alias": alias, "warmed": warm_batch is not None,
                "warm_ms": 1e3 * swap["warm_s"], "drained": swap["drained"]}

    # --- introspection --------------------------------------------------------

    def status(self, name: str) -> Dict[str, Any]:
        """Store versions + manifests, loaded versions, and per-alias
        activity for one model — the GET /v1/models/{name} payload."""
        store_versions = self.store.versions(name)
        loaded = self.registry.versions(name)
        if not store_versions and not loaded:
            raise LifecycleError(f"unknown model {name!r}")
        active = {a: m[name] for a, m in self._active.items() if name in m}
        with self._stats_lock:
            traffic = {k: dict(v) for k, v in self._version_traffic.items()
                       if k.startswith(f"{name}@v")}
        return {
            "name": name,
            "versions": [self.store.manifest(name, v)
                         for v in store_versions],
            "loaded_versions": loaded,
            "active": active,
            "previous": {a: v for (a, n), v in self._previous.items()
                         if n == name},
            "engine_active": {a: v
                              for a, (n, v) in self._engine_active.items()
                              if n == name},
            "traffic": traffic,
        }

    def memory_ledger(self, n_chips: int = 1, **kw) -> MemoryLedger:
        """Params of every loaded version (``name@vN``) against the card's
        memory (pass ``hbm_per_chip`` on a host without a CUDA device); an
        unloaded version leaves it."""
        ledger = MemoryLedger(n_chips=n_chips, **kw)
        for row in self.registry.describe():
            rm = self.registry.get(row["name"], row["version"])
            ledger.add_params(f"{rm.name}@v{rm.version}", rm.params)
        return ledger

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            out: Dict[str, Any] = dict(self._counters)
            out["last_warm_ms"] = 1e3 * self._last_warm_s
            out["warm_total_ms"] = 1e3 * self._warm_total_s
            out["per_version"] = {k: dict(v)
                                  for k, v in self._version_traffic.items()}
        out["aliases"] = {a: dict(m) for a, m in self._active.items()}
        out["engine_aliases"] = {a: f"{n}@v{v}" for a, (n, v)
                                 in self._engine_active.items()}
        out["engine_drafts"] = {a: f"{n}@v{v}" for a, (n, v)
                                 in self._engine_drafts.items()}
        return out
