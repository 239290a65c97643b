"""FlexServe REST server — a lean thread-per-connection HTTP front-end.

The port of ``repro/serving/server.py``.  A threaded front-end accepts
concurrent client connections, with a hand-rolled keep-alive HTTP/1.1
handler.  Ensemble routes (/v1/infer, /v1/detect) funnel through a
``BatchCoalescer`` that merges concurrent requests' rows into one bucketed
forward on the card; /v1/generate goes through a ``GenerationService``
that admits prompts into continuous-batching decode slots (blocking, or
streamed as chunked NDJSON), optionally behind a health-checked
``ReplicaPool`` with failover.  ``coalesce=False`` runs one request per
forward behind a device lock instead.

Every request-plane route runs under the flight recorder (tracing is on
by default): the trace begins at the HTTP boundary, every layer appends
its spans, and ``GET /v1/trace/{id}`` / ``/v1/traces`` read them back;
sealed traces feed the windowed SLIs and the usage ledger (``/v1/usage``,
``/v1/slo``) and the SLO autopilot acts through the lifecycle manager.
With a ``ModelManager`` attached, the endpoint gains the lifecycle admin
surface (GET /v1/models/{name}, POST .../load /unload /rollback /gc,
POST /v1/engines/{name}/load|rollback) and per-request version-alias
targeting — hot swaps happen under live traffic with zero dropped
requests.  A ``"draft"`` on the engine plane loads a speculative pair
(``ModelManager.load_engine(draft=...)``; the JAX route drops the field).

Endpoints are defined in ``repro_torch.serving.api``.
"""

from __future__ import annotations

import socketserver
import threading
import time
import urllib.parse
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.batching import BucketSpec
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.ensemble import BATCH_COUNTS, Ensemble
from repro_torch.core.faults import (ZERO_FAULT_STATS, FaultInjector,
                                     InjectedFault)
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.slo import (ZERO_SLO, SLIStore, SLOController,
                                  UsageLedger, load_policies)
from repro_torch.core.telemetry import Stages
from repro_torch.serving import api
from repro_torch.serving.admission import (AdmissionController, DeadlineError,
                                           RequestContext, ShedError)
from repro_torch.serving.client import FlexServeClient
from repro_torch.serving.coalesce import (DISPATCH_STAGES, FRONTEND_STAGES,
                                          PARSE, RESPOND, BatchCoalescer)
from repro_torch.serving.generate import GenerationError, GenerationService
from repro_torch.serving.lifecycle import LifecycleError, ModelManager
from repro_torch.serving.modelstore import StoreError
from repro_torch.serving.replica import ZERO_REPLICA_STATS
from repro_torch.serving.telemetry import (DeviceProfiler, FlightRecorder,
                                           prometheus_exposition)

# lifecycle section served when no manager is attached, so the /metrics
# key set (and the Prometheus exposition) is identical either way
_ZERO_LIFECYCLE: Dict[str, Any] = {
    "loads": 0, "unloads": 0, "swaps": 0, "rollbacks": 0,
    "engine_loads": 0, "engine_rollbacks": 0,
    "engine_promotes": 0, "engine_demotes": 0, "gc_runs": 0,
    "last_warm_ms": 0.0, "warm_total_ms": 0.0, "per_version": {},
    "aliases": {}, "engine_aliases": {}}

# the /v1/infer path's stages (``Stages``), reported in /metrics
# ``stages`` whether or not they are recorded
INFER_STAGES = DISPATCH_STAGES + FRONTEND_STAGES
# the routes whose handler threads record the front end's stages
_STAGED_ROUTES = ("/v1/infer", "/v1/detect")


class FlexServeApp:
    """Bundles a registry, an optional ensemble/manager, and an engine.

    ``trace`` (default on) runs every request-plane route under a
    ``FlightRecorder`` of ``flight_recorder_size`` sealed traces, and
    records the /v1/infer path's stages (``stages``: the coalescer's
    dispatch loop, each forward on the device's clock, the front end's
    parse and respond; profiler ranges ``flexserve.<stage>`` while a
    ``POST /v1/debug/profile`` capture records);
    ``profile_dir`` enables ``POST /v1/debug/profile``; ``slo_policies``
    (anything ``load_policies`` takes) starts the SLO autopilot, which
    evaluates every ``slo_interval_s`` over ``sli_n_buckets`` windows of
    ``sli_bucket_s``.  ``max_wait_ms`` / ``max_coalesce_rows`` tune the coalescer (how long
    the dispatcher lingers for more rows — ``None`` derives the linger
    adaptively from the observed arrival rate — and the rows-per-forward
    cap); ``num_slots`` sizes each continuous-batching decode pool.  Pass
    a ``manager`` instead of a static ``ensemble`` to serve store-backed,
    hot-swappable models; with a manager attached, generation engines are
    versioned and hot-swappable too (POST /v1/engines/{name}/load).

    ``replicas > 1`` runs the generate plane as a health-checked
    ``ReplicaPool`` — N independent decode schedulers over the shared engine, with automatic cordon/restart and
    transparent failover (see GET /v1/replicas).  ``fault_config``
    accepts anything :meth:`FaultInjector.load` does (path / dict /
    injector) and arms the deterministic chaos sites across every layer;
    ``replica_options`` passes pool tuning knobs (health thresholds)
    straight through.
    """

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 ensemble: Optional[Ensemble] = None,
                 engine: Optional[InferenceEngine] = None, *,
                 manager: Optional[ModelManager] = None,
                 coalesce: bool = True,
                 max_wait_ms: Optional[float] = None,
                 max_coalesce_rows: Optional[int] = None,
                 num_slots: int = 4,
                 max_queue: int = 64,
                 bulk_fraction: float = 0.5,
                 default_deadline_ms: Optional[float] = None,
                 max_stream_buffer: int = 32,
                 generate_token_budget: Optional[int] = None,
                 trace: bool = True,
                 flight_recorder_size: int = 256,
                 profile_dir: Optional[str] = None,
                 slo_policies: Any = None,
                 slo_interval_s: float = 2.0,
                 sli_bucket_s: float = 10.0,
                 sli_n_buckets: int = 60,
                 client_weights: Optional[Dict[str, float]] = None,
                 replicas: int = 1,
                 fault_config: Any = None,
                 replica_options: Optional[Dict[str, Any]] = None):
        if manager is not None and ensemble is not None:
            raise ValueError("pass either a static ensemble or a manager")
        self.manager = manager
        # one injector shared by every layer (scheduler drivers, lifecycle
        # loads, the stream writer) so a single config file describes the
        # whole chaos drill
        self.faults: Optional[FaultInjector] = FaultInjector.load(
            fault_config)
        if manager is not None and self.faults is not None \
                and getattr(manager, "faults", None) is None:
            manager.faults = self.faults
        self.registry = (manager.registry if manager is not None
                         else registry or ModelRegistry())
        self._ensemble = ensemble
        self.engine = engine
        self.device_lock = threading.Lock()
        self.request_count = 0
        # monotonic for uptime arithmetic; the wall time is only reported
        self._t0 = time.monotonic()
        self._started_unix = time.time()
        # SLI/usage aggregation rides the flight recorder's completion
        # hook: both stay zeroed (but present in /metrics) with tracing
        # off, so the schema is identical either way
        self.sli = SLIStore(bucket_s=sli_bucket_s, n_buckets=sli_n_buckets)
        self.usage = UsageLedger()
        self.slo: Optional[SLOController] = None
        self.recorder: Optional[FlightRecorder] = (
            FlightRecorder(capacity=flight_recorder_size,
                           on_complete=self._ingest_trace)
            if trace else None)
        self.stages: Optional[Stages] = (Stages(INFER_STAGES) if trace
                                         else None)
        self.profiler: Optional[DeviceProfiler] = (
            DeviceProfiler(artifact_dir=profile_dir, stages=self.stages)
            if profile_dir is not None else None)
        self._closing = False
        self._route_stats: Dict[str, Dict[str, float]] = {}
        self._stats_lock = threading.Lock()
        # the generate plane is budgeted in TOKEN units (prompt length +
        # requested max_new_tokens): a single huge request can't slip in
        # as "one row".  Default scales the row budget by a typical
        # per-request token footprint.
        self.generate_token_budget = (
            generate_token_budget if generate_token_budget is not None
            else 32 * max_queue)
        self.admission = AdmissionController(
            max_queue=max_queue, bulk_fraction=bulk_fraction,
            default_deadline_ms=default_deadline_ms,
            plane_budgets={"generate": self.generate_token_budget},
            client_weights=client_weights)
        self.coalescer: Optional[BatchCoalescer] = None
        self.generation: Optional[GenerationService] = None
        if coalesce and (ensemble is not None or manager is not None):
            buckets = (ensemble.batch_buckets if ensemble is not None
                       else BucketSpec.pow2(manager.max_batch))
            self.coalescer = BatchCoalescer(
                self._coalesced_forward, buckets,
                max_wait_ms=max_wait_ms, max_rows=max_coalesce_rows,
                stages=self.stages, device=self._forward_device)
        if coalesce and (engine is not None or manager is not None):
            self.generation = GenerationService(
                engine, num_slots=num_slots,
                max_pending=max(num_slots, max_queue),
                max_stream_buffer=max_stream_buffer,
                client_weights=client_weights,
                num_replicas=replicas,
                faults=self.faults,
                replica_options=replica_options)
            if manager is not None:
                manager.attach_generation(self.generation)
        policies = load_policies(slo_policies) if slo_policies else []
        if policies:
            self.slo = SLOController(
                self.sli, policies,
                resolve=self._slo_resolve, promote=self._slo_promote,
                rollback=self._slo_rollback, recorder=self.recorder,
                interval_s=slo_interval_s)
            self.slo.start()

    @property
    def ensemble(self) -> Optional[Ensemble]:
        """The default-alias ensemble (manager-backed or static)."""
        if self.manager is not None:
            return (self.manager.ensemble_for() if self.manager.ready
                    else None)
        return self._ensemble

    def _coalesced_forward(self, batch, alias, ctxs=None):
        """Coalescer's forward: route one merged group to its target,
        handing the group's RequestContexts to the lifecycle manager's
        per-version traffic accounting."""
        if self.manager is not None:
            return self.manager.forward(batch, alias, ctxs)
        return self._ensemble.forward(batch)

    def _forward_device(self):
        ens = self.ensemble
        return ens.device if ens is not None else None

    def close(self) -> None:
        """Stop background dispatch threads (idempotent)."""
        self._closing = True
        if self.slo is not None:
            self.slo.close()
        if self.coalescer is not None:
            self.coalescer.close()
            self.coalescer = None
        if self.generation is not None:
            self.generation.close()
            self.generation = None

    # --- SLO autopilot glue ---------------------------------------------------

    def _ingest_trace(self, tr) -> None:
        """FlightRecorder completion hook: fold one sealed trace into the
        windowed SLIs and the per-client/per-version usage ledger.  499
        (client cancelled) is not an availability error; a deadline miss
        is either a 504 or a request whose streams all hit 'deadline'."""
        if tr.plane == "slo":                 # autopilot audit traces
            return
        status = tr.status if tr.status is not None else 200
        end_s = tr.end_s if tr.end_s is not None else tr.start_s
        ttft_ms = None
        for ev in tr.events:
            if ev.get("name") == "first_token":
                ttft_ms = 1e3 * (ev["t"] - tr.start_s)
                break
        error = status >= 500
        miss = status == 504 or tr.finish_reason == "deadline"
        version = tr.attrs.get("version")
        self.sli.ingest(plane=tr.plane, client=tr.client, version=version,
                        latency_ms=1e3 * (end_s - tr.start_s), error=error,
                        deadline_miss=miss, ttft_ms=ttft_ms)
        self.usage.ingest(plane=tr.plane, client=tr.client, version=version,
                          error=error, counters=tr.counters)

    def _slo_resolve(self, alias: str) -> Optional[str]:
        """Version label currently serving ``alias`` (None when unknown)."""
        if self.manager is not None:
            label = self.manager.engine_version_label(alias)
            if label is not None:
                return label
        if self.generation is not None:
            try:
                return self.generation.entry_for(alias).label
            except GenerationError:
                return None
        return None

    def _slo_promote(self, policy) -> Dict[str, Any]:
        if self.manager is not None and \
                self.manager.engine_version_label(policy.alias) is not None:
            return self.manager.promote_engine(policy.alias,
                                               to_alias=policy.promote_to)
        if self.generation is None:
            raise GenerationError("no generation service to actuate")
        return self.generation.repoint(policy.alias, policy.promote_to)

    def _slo_rollback(self, policy) -> Dict[str, Any]:
        if self.manager is not None and \
                self.manager.engine_version_label(policy.promote_to) \
                is not None:
            return self.manager.demote_engine(policy.alias,
                                              to_alias=policy.promote_to)
        if self.generation is None:
            raise GenerationError("no generation service to actuate")
        return self.generation.repoint(policy.promote_to, policy.alias)

    # --- readiness ------------------------------------------------------------

    def ready(self) -> Dict[str, Any]:
        """Readiness probe payload; raises 503 while not servable.

        With a generation service attached the probe aggregates replica
        health: the payload reports the ready count and the cordoned set,
        and the endpoint goes 503 the moment ZERO replicas can take work
        — a load balancer drains it before clients see hard failures."""
        if self._closing:
            raise api.ApiError(503, "shutting down")
        if self.coalescer is not None and not self.coalescer.alive:
            raise api.ApiError(503, "coalescer dispatch thread not alive")
        if self.manager is not None:
            if not self.manager.ready:
                raise api.ApiError(503, "no models loaded yet")
        elif (self._ensemble is None and self.engine is None
              and len(self.registry) == 0):
            raise api.ApiError(503, "no models loaded yet")
        out = {"status": "ready", "models": len(self.registry),
               "coalescing": self.coalescer is not None}
        if self.generation is not None and self.generation.ready:
            rs = self.generation.replica_summary()
            out["replicas"] = {"count": rs["count"], "ready": rs["ready"],
                               "cordoned": list(rs["cordoned_ids"])}
            if rs["count"] > 0 and rs["ready"] == 0:
                raise api.ApiError(
                    503, f"no ready replicas ({rs['count']} configured: "
                         f"{rs['warming']} warming, {rs['cordoned']} "
                         f"cordoned, {rs['restarting']} restarting)")
        return out

    # --- route handlers ------------------------------------------------------

    @staticmethod
    def _stats_key(method: str, path: str) -> str:
        """Route-stats bucket: query string stripped, parametric path
        segments collapsed so the stats dict stays bounded."""
        path = path.partition("?")[0]
        if path.startswith("/v1/trace/"):
            path = "/v1/trace/{id}"
        return f"{method} {path}"

    def handle(self, method: str, path: str, body: bytes,
               headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        with self._stats_lock:
            self.request_count += 1
        t0 = time.perf_counter()
        try:
            return self._route(method, path, body, headers, t0)
        finally:
            dt = time.perf_counter() - t0
            with self._stats_lock:
                st = self._route_stats.setdefault(
                    self._stats_key(method, path),
                    {"count": 0, "total_s": 0.0, "max_s": 0.0})
                st["count"] += 1
                st["total_s"] += dt
                st["max_s"] = max(st["max_s"], dt)

    def _route(self, method: str, path: str, body: bytes,
               headers: Optional[Dict[str, str]] = None,
               arrival: Optional[float] = None) -> Dict[str, Any]:
        path, _, qs = path.partition("?")
        query = dict(urllib.parse.parse_qsl(qs)) if qs else {}
        if method == "GET" and path == "/health":
            return {"status": "ok", "requests": self.request_count}
        if method == "GET" and path == "/healthz":
            return self.ready()
        if method == "GET" and path == "/metrics":
            return self._metrics(fmt=query.get("format", "json"))
        if method == "GET" and path.startswith("/v1/trace/"):
            return self._trace_lookup(path[len("/v1/trace/"):])
        if method == "GET" and path == "/v1/traces":
            return self._traces_index(query)
        if method == "GET" and path == "/v1/usage":
            return self._usage(query)
        if method == "GET" and path == "/v1/slo":
            return self._slo_status(query)
        if path == "/v1/debug/profile":
            return self._profile_admin(method, body)
        if method == "GET" and path == "/v1/models":
            return {"models": self.registry.describe(),
                    "ensemble_size": (len(self.ensemble.members)
                                      if self.ensemble else 0)}
        if path.startswith("/v1/models/"):
            return self._model_admin(method, path[len("/v1/models/"):],
                                     body)
        if method == "GET" and path == "/v1/engines":
            return self._engines_status()
        if path.startswith("/v1/engines/"):
            return self._engine_admin(method, path[len("/v1/engines/"):],
                                      body)
        if method == "GET" and path == "/v1/replicas":
            return self._replicas_status(query)
        if path.startswith("/v1/replicas/"):
            return self._replica_admin(method,
                                       path[len("/v1/replicas/"):], body)
        if method == "POST" and path == "/v1/infer":
            return self._traced("infer", body, headers, arrival,
                                self._infer)
        if method == "POST" and path == "/v1/detect":
            return self._traced("detect", body, headers, arrival,
                                self._detect)
        if method == "POST" and path == "/v1/generate":
            return self._traced("generate", body, headers, arrival,
                                self._generate)
        raise api.ApiError(404, f"no route {method} {path}")

    def _traced(self, plane: str, body: bytes,
                headers: Optional[Dict[str, str]],
                arrival: Optional[float], fn):
        """Run a request-plane route under the flight recorder: begin a
        trace keyed by the request's trace_id, record the HTTP parse span,
        attach the live trace to the RequestContext (every downstream
        layer picks it up from there), and seal it when the route returns.
        Streaming responses are sealed by the stream's terminal event
        instead; error paths (shed, deadline, 5xx) seal here so they stay
        queryable via GET /v1/trace/{id}."""
        req = api.parse_request(body)
        ctx = self._context(req, headers, arrival)
        tr = None
        if self.recorder is not None:
            tr = self.recorder.begin(ctx.trace_id, plane,
                                     client=ctx.client,
                                     priority=ctx.priority,
                                     start_s=ctx.arrival_s)
            ctx.trace = tr
            tr.span("http_parse", ctx.arrival_s, time.perf_counter(),
                    bytes=len(body))
        try:
            out = fn(req, ctx)
        except api.ApiError as e:
            if tr is not None:
                e.headers.setdefault("X-Request-Id", ctx.trace_id)
                tr.finish(status=e.status, error=e.message)
            raise
        except Exception as e:              # noqa: BLE001 — seal, re-raise
            if tr is not None:
                tr.finish(status=500, error=f"{type(e).__name__}: {e}")
            raise
        if isinstance(out, api.StreamingResponse):
            if tr is not None:
                out.headers.setdefault("X-Request-Id", ctx.trace_id)
            return out
        if tr is not None:
            tr.finish(status=200)
            return api.JsonResponse(out, {"X-Request-Id": ctx.trace_id})
        return out

    # --- telemetry surface ----------------------------------------------------

    def _trace_lookup(self, trace_id: str) -> Dict[str, Any]:
        if self.recorder is None:
            raise api.ApiError(404, "tracing is disabled on this endpoint")
        trace_id = urllib.parse.unquote(trace_id)
        tr = self.recorder.get(trace_id)
        if tr is None:
            raise api.ApiError(
                404, f"no trace {trace_id!r} (evicted from the flight "
                     f"recorder, or never admitted)")
        return tr.snapshot()

    def _traces_index(self,
                      query: Optional[Dict[str, str]] = None
                      ) -> Dict[str, Any]:
        if self.recorder is None:
            raise api.ApiError(404, "tracing is disabled on this endpoint")
        query = query or {}
        try:
            limit = int(query.get("limit", 20))
            min_ms = (float(query["min_duration_ms"])
                      if "min_duration_ms" in query else None)
            want_status = (int(query["status"]) if "status" in query
                           else None)
        except ValueError as e:
            raise api.ApiError(400, f"bad traces filter: {e}") from None
        if limit < 1:
            raise api.ApiError(400, "'limit' must be an integer >= 1")
        want_client = query.get("client")
        filtered = (want_status is not None or want_client is not None
                    or min_ms is not None)
        # with filters active, scan the whole ring so matches older than
        # the newest `limit` rows still surface
        rows = self.recorder.recent(
            n=self.recorder.capacity if filtered else limit)
        if want_status is not None:
            rows = [r for r in rows if r["status"] == want_status]
        if want_client is not None:
            rows = [r for r in rows if r["client"] == want_client]
        if min_ms is not None:
            rows = [r for r in rows if r["duration_ms"] >= min_ms]
        return {"telemetry": self.recorder.stats(),
                "in_flight": self.recorder.in_flight(),
                "recent": rows[:limit]}

    def _usage(self, query: Dict[str, str]) -> Dict[str, Any]:
        return self.usage.snapshot(client=query.get("client"),
                                   version=query.get("version"))

    def _slo_status(self, query: Dict[str, str]) -> Dict[str, Any]:
        try:
            window_s = float(query.get("window_s", 60.0))
        except ValueError as e:
            raise api.ApiError(400, f"bad slo query: {e}") from None
        if self.slo is not None:
            return {"enabled": True,
                    **self.slo.status(window_s=window_s)}
        return {"enabled": False, **dict(ZERO_SLO), "policies": [],
                "decisions": [], "sli": self.sli.snapshot(window_s)}

    def _profile_admin(self, method: str, body: bytes) -> Dict[str, Any]:
        if self.profiler is None:
            raise api.ApiError(
                503, "profiling is disabled; start the endpoint with a "
                     "--profile-dir to enable it")
        if method == "GET":
            return self.profiler.status()
        if method != "POST":
            raise api.ApiError(404,
                               f"no route {method} /v1/debug/profile")
        req = api.parse_request(body)
        duration = api.opt_int(req, "duration_ms", 1000)
        mode = str(req.get("mode", "auto"))
        if mode not in DeviceProfiler.MODES:
            raise api.ApiError(400,
                               "'mode' must be 'auto', 'torch' or 'python'")
        try:
            out = self.profiler.start(duration_ms=duration, mode=mode)
        except RuntimeError as e:
            raise api.ApiError(409, str(e)) from None
        except ValueError as e:
            raise api.ApiError(400, str(e)) from None
        return api.JsonResponse(out, status=202)

    # --- request plane --------------------------------------------------------

    def _context(self, req: Dict[str, Any],
                 headers: Optional[Dict[str, str]],
                 arrival: Optional[float]) -> RequestContext:
        try:
            return self.admission.context(req, headers, arrival_s=arrival)
        except ValueError as e:
            raise api.ApiError(400, str(e)) from None

    @staticmethod
    def _shed_to_api(e: ShedError) -> api.ApiError:
        return api.ApiError(
            429, str(e),
            headers={"Retry-After": format(e.retry_after_s, ".3f")})

    def _admit(self, plane: str, ctx: RequestContext, cost: int):
        try:
            return self.admission.admit(plane, ctx, cost)
        except ShedError as e:
            raise self._shed_to_api(e) from None
        except DeadlineError as e:
            raise api.ApiError(504, str(e)) from None

    def _metrics(self, fmt: str = "json"):
        with self._stats_lock:
            routes = {
                k: {"count": v["count"],
                    "mean_ms": 1e3 * v["total_s"] / max(v["count"], 1),
                    "max_ms": 1e3 * v["max_s"]}
                for k, v in self._route_stats.items()}
            requests = self.request_count
        out = {"uptime_s": time.monotonic() - self._t0,
               "started_unix": self._started_unix,
               "requests": requests, "routes": routes}
        if self.coalescer is not None:
            out["coalesce"] = self.coalescer.stats()
        if self.ensemble is not None:
            out["ensemble_compiles"] = {
                str(b): c
                for b, c in sorted(self.ensemble.compile_counts.items())}
        # always present, like the sections below: the batcher's counters
        # (zero with no ensemble) and the stages (zeroed with tracing off)
        out["ensemble_batches"] = (self.ensemble.batch_counts
                                   if self.ensemble is not None
                                   else dict.fromkeys(BATCH_COUNTS, 0))
        out["stages"] = (self.stages if self.stages is not None
                         else Stages(INFER_STAGES)).snapshot()
        out["lifecycle"] = (self.manager.stats() if self.manager is not None
                            else dict(_ZERO_LIFECYCLE))
        if self.generation is not None:
            out["generate"] = self.generation.stats()
        out["admission"] = self.admission.stats()
        # always present (zeroed with tracing off) so the /metrics schema
        # — and the Prometheus exposition — is stable across configs
        out["replicas"] = (self.generation.replica_summary()
                           if self.generation is not None
                           else dict(ZERO_REPLICA_STATS))
        out["faults"] = (self.faults.stats() if self.faults is not None
                         else dict(ZERO_FAULT_STATS))
        out["usage"] = self.usage.totals()
        out["slo"] = (self.slo.stats() if self.slo is not None
                      else dict(ZERO_SLO))
        if self.recorder is not None:
            out["telemetry"] = self.recorder.stats()
        if fmt == "prometheus":
            return api.PlainTextResponse(prometheus_exposition(out))
        if fmt != "json":
            raise api.ApiError(400, f"unknown metrics format {fmt!r}")
        return out

    # --- lifecycle admin surface ---------------------------------------------

    def _model_admin(self, method: str, rest: str,
                     body: bytes) -> Dict[str, Any]:
        name, _, action = rest.partition("/")
        # member names may contain '#' (e.g. "yi-9b#0"), which clients must
        # percent-encode — decode the path segment here
        name = urllib.parse.unquote(name)
        if not name:
            raise api.ApiError(404, "missing model name")
        if method == "GET" and not action:
            return self._model_status(name)
        if method != "POST" or action not in ("load", "unload", "rollback",
                                              "gc"):
            raise api.ApiError(404,
                               f"no route {method} /v1/models/{rest}")
        mgr = self._require_manager()
        req = api.parse_request(body)
        version = api.opt_int(req, "version", 0) or None
        alias = req.get("alias")
        try:
            if action == "load":
                return mgr.load(name, version, alias=alias,
                                warm=bool(req.get("warm", True)))
            if action == "unload":
                return mgr.unload(name, version)
            if action == "gc":
                keep = api.opt_int(req, "keep_last_n", 0)
                if keep < 1:
                    raise api.ApiError(
                        400, "'keep_last_n' must be an integer >= 1")
                return mgr.gc(name, keep)
            return mgr.rollback(name, alias=alias,
                                warm=bool(req.get("warm", True)))
        except StoreError as e:
            raise api.ApiError(404, str(e)) from None
        except KeyError as e:
            raise api.ApiError(404, str(e)) from None
        except LifecycleError as e:
            raise api.ApiError(409, str(e)) from None

    # --- generation-engine admin surface --------------------------------------

    def _engines_status(self) -> Dict[str, Any]:
        gen = self.generation
        if gen is None:
            return {"aliases": {}, "ready": False}
        stats = gen.stats()
        return {"aliases": {a: e["engine"]
                            for a, e in stats["engines"].items()},
                "ready": gen.ready}

    def _engine_admin(self, method: str, rest: str,
                      body: bytes) -> Dict[str, Any]:
        name, _, action = rest.partition("/")
        name = urllib.parse.unquote(name)
        if not name:
            raise api.ApiError(404, "missing engine name")
        if method != "POST" or action not in ("load", "rollback"):
            raise api.ApiError(404,
                               f"no route {method} /v1/engines/{rest}")
        mgr = self._require_manager()
        req = api.parse_request(body)
        version = api.opt_int(req, "version", 0) or None
        alias = req.get("alias")
        warm = bool(req.get("warm", True))
        try:
            if action == "load":
                return mgr.load_engine(
                    name, version, alias=alias, warm=warm,
                    draft=req.get("draft"),
                    draft_version=api.opt_int(req, "draft_version", 0)
                    or None,
                    max_window=api.opt_int(req, "max_window", 4))
            return mgr.rollback_engine(name, alias=alias, warm=warm)
        except StoreError as e:
            raise api.ApiError(404, str(e)) from None
        except KeyError as e:
            raise api.ApiError(404, str(e)) from None
        except LifecycleError as e:
            raise api.ApiError(409, str(e)) from None

    # --- replica admin surface ------------------------------------------------

    def _replicas_status(self, query: Dict[str, str]) -> Dict[str, Any]:
        """Per-replica lifecycle states and pool counters.  Works in
        single-service mode too (the one implicit replica is reported),
        so dashboards don't need to know how the endpoint was started."""
        if self.generation is None:
            return dict(ZERO_REPLICA_STATS)
        return self.generation.replica_summary(query.get("target"))

    def _replica_admin(self, method: str, rest: str,
                       body: bytes) -> Dict[str, Any]:
        """POST /v1/replicas/{id}/cordon|uncordon — operator drain
        control.  Cordon is drain-aware (in-flight work finishes in
        place); uncordon restarts the replica first if its driver died."""
        rid_s, _, action = rest.partition("/")
        if method != "POST" or action not in ("cordon", "uncordon"):
            raise api.ApiError(404,
                               f"no route {method} /v1/replicas/{rest}")
        req = api.parse_request(body)
        pool = (self.generation.pool_for(req.get("target"))
                if self.generation is not None else None)
        if pool is None:
            raise api.ApiError(
                409, "no replica pool on this endpoint; start it with "
                     "--replicas > 1 to enable cordon/uncordon")
        try:
            rid = int(rid_s)
        except ValueError:
            raise api.ApiError(404, f"bad replica id {rid_s!r}") from None
        try:
            if action == "cordon":
                reason = str(req.get("reason", "manual cordon"))
                return pool.cordon(rid, reason=reason)
            return pool.uncordon(rid)
        except KeyError as e:
            raise api.ApiError(404, str(e)) from None

    def _model_status(self, name: str) -> Dict[str, Any]:
        if self.manager is not None:
            try:
                return self.manager.status(name)
            except (LifecycleError, StoreError) as e:
                raise api.ApiError(404, str(e)) from None
        try:
            rm = self.registry.get(name)
        except KeyError as e:
            raise api.ApiError(404, str(e)) from None
        return {"name": name, "versions": [],
                "loaded_versions": self.registry.versions(name),
                "active": {}, "meta": {k: v for k, v in rm.meta.items()
                                       if isinstance(v, (str, int, float))}}

    def _require_manager(self) -> ModelManager:
        if self.manager is None:
            raise api.ApiError(
                503, "no lifecycle manager on this endpoint; start it with "
                     "a model store to enable load/unload/rollback")
        return self.manager

    # --- inference routes ----------------------------------------------------

    def _require_ensemble(self, alias: Optional[str] = None) -> Ensemble:
        if self.manager is not None:
            try:
                return self.manager.ensemble_for(alias)
            except LifecycleError as e:
                raise api.ApiError(404, str(e)) from None
        if alias is not None:
            raise api.ApiError(
                400, "per-request 'target' aliases need a lifecycle "
                     "manager on this endpoint")
        if self._ensemble is None:
            raise api.ApiError(503, "no ensemble deployed on this endpoint")
        return self._ensemble

    def _ensemble_logits(self, batch, alias: Optional[str],
                         ctx: RequestContext) -> Dict[str, np.ndarray]:
        """One forward's worth of per-member logits for this request's rows —
        coalesced with concurrent requests (of the same signature AND the
        same alias target) when the coalescer is on.  Admission is charged
        per ROW; a missed deadline surfaces as 504, a full queue as 429."""
        ens = self._require_ensemble(alias)
        rows = next(iter(batch.values())).shape[0]
        ticket = self._admit("infer", ctx, rows)
        try:
            if self.coalescer is not None:
                return self.coalescer.submit(batch, tag=alias, ctx=ctx)
            clk = self.stages.clock() if self.stages is not None else None
            handed = clk is not None and clk.stage == PARSE
            if handed:
                clk.stop()
            with self.device_lock:
                if ctx.expired():
                    raise DeadlineError(
                        "deadline exceeded waiting for the device lock")
                if self.manager is not None:
                    out = self.manager.forward(batch, alias, [ctx])
                else:
                    out = ens.forward(batch)
            if handed:
                clk.switch(RESPOND)
            return out
        except DeadlineError as e:
            self.admission.deadline_miss(
                "infer", "coalesce" if self.coalescer is not None
                else "device_lock")
            raise api.ApiError(504, str(e)) from None
        except LifecycleError as e:
            raise api.ApiError(404, str(e)) from None
        except KeyError as e:
            raise api.ApiError(400, str(e)) from None
        except ValueError as e:
            raise api.ApiError(400, str(e)) from None
        finally:
            ticket.release()

    def _infer(self, req, ctx: RequestContext) -> Dict[str, Any]:
        alias = req.get("target")
        ens = self._require_ensemble(alias)
        batch = api.inputs_to_batch(req.get("inputs", {}))
        policy = req.get("policy", "soft_vote")
        logits = self._ensemble_logits(batch, alias, ctx)
        try:
            return ens.respond_from_logits(logits, policy=policy)
        except (KeyError, ValueError) as e:
            raise api.ApiError(400, str(e)) from None

    def _detect(self, req, ctx: RequestContext) -> Dict[str, Any]:
        alias = req.get("target")
        ens = self._require_ensemble(alias)
        batch = api.inputs_to_batch(req.get("inputs", {}))
        if "positive_class" not in req:
            raise api.ApiError(400, "'positive_class' is required")
        logits = self._ensemble_logits(batch, alias, ctx)
        out = ens.detect_from_logits(
            logits, positive_class=int(req["positive_class"]),
            threshold=float(req.get("threshold", 0.5)),
            policy=req.get("policy", "or"))
        resp = {f"model_{i}": v
                for i, v in enumerate(out["members"].values())}
        resp["ensemble"] = out["ensemble"]
        resp["policy"] = req.get("policy", "or")
        return resp

    def _generate(self, req, ctx: RequestContext):
        prompts = req.get("prompts")
        if not prompts or not isinstance(prompts, list):
            raise api.ApiError(400, "'prompts' must be a list of token lists")
        sampling = api.parse_sampling(req)
        alias = req.get("target")
        if req.get("stream"):
            return self._generate_stream(prompts, sampling, alias, ctx)
        cost = sum(len(p) for p in prompts if isinstance(p, list)) \
            + len(prompts) * sampling.max_new_tokens
        ticket = self._admit("generate", ctx, cost)
        try:
            if self.generation is not None and (self.generation.ready
                                                or alias is not None):
                res = self.generation.generate(prompts, sampling,
                                               alias=alias, ctx=ctx)
            elif self.engine is not None:
                if alias is not None:
                    raise api.ApiError(
                        400, "per-request 'target' aliases need a "
                             "generation service on this endpoint")
                with self.device_lock:
                    if ctx.expired():
                        self.admission.deadline_miss("generate",
                                                     "device_lock")
                        raise api.ApiError(
                            504, "deadline exceeded waiting for the "
                                 "device lock")
                    res = self.engine.generate(prompts, sampling=sampling)
            else:
                raise api.ApiError(503, "no generation engine deployed")
        except ShedError as e:
            raise self._shed_to_api(e) from None
        except GenerationError as e:
            raise api.ApiError(404, str(e)) from None
        except (ValueError, TypeError) as e:
            raise api.ApiError(400, str(e)) from None
        finally:
            ticket.release()
        if res.finish_reasons and all(r == "deadline"
                                      for r in res.finish_reasons):
            self.admission.deadline_miss("generate", "scheduler")
            raise api.ApiError(
                504, f"deadline exceeded before decode "
                     f"({ctx.trace_id or 'request'})")
        return {"outputs": res.tokens, "steps": res.steps,
                "prompt_lengths": res.prompt_lengths,
                "finish_reasons": res.finish_reasons}

    def _generate_stream(self, prompts, sampling, alias,
                         ctx: RequestContext) -> api.StreamingResponse:
        if self.generation is None or not (self.generation.ready
                                           or alias is not None):
            raise api.ApiError(
                503, "streaming needs the scheduler-backed generation "
                     "service (engine deployed, coalesce=True)")
        if len(prompts) != 1:
            raise api.ApiError(
                400, "streaming supports exactly one prompt per request")
        cost = (len(prompts[0]) if isinstance(prompts[0], list) else 1) \
            + sampling.max_new_tokens
        ticket = self._admit("generate", ctx, cost)
        try:
            # the ticket's budget hold lives as long as the stream: it is
            # released by the terminal event or by disconnect-cancellation
            stream = self.generation.stream(prompts[0], sampling,
                                            alias=alias, ctx=ctx,
                                            on_finish=ticket.release)
        except ShedError as e:
            ticket.release()
            raise self._shed_to_api(e) from None
        except GenerationError as e:
            ticket.release()
            raise api.ApiError(404, str(e)) from None
        except (ValueError, TypeError) as e:
            ticket.release()
            raise api.ApiError(400, str(e)) from None
        except BaseException:
            ticket.release()
            raise
        return api.StreamingResponse(stream.events(),
                                     on_disconnect=stream.cancel)


_REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request",
            404: "Not Found", 409: "Conflict", 429: "Too Many Requests",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable", 504: "Gateway Timeout"}

# request-plane headers the lean parser captures (already lowercase)
_PLANE_HEADERS = (b"x-flexserve-priority", b"x-flexserve-deadline-ms",
                  b"x-flexserve-client", b"x-request-id")


def make_handler(app: FlexServeApp):
    class Handler(socketserver.StreamRequestHandler):
        """Lean HTTP/1.1 keep-alive handler: request line, Content-Length,
        Connection and the request-plane headers; a response goes out as
        ONE write (no Nagle/delayed-ACK stalls when a coalesced batch
        releases many responses at once), a token stream as one chunk per
        event."""

        disable_nagle_algorithm = True
        timeout = 120

        def handle(self):
            try:
                while self._one_request():
                    pass
            except (ConnectionError, TimeoutError, OSError):
                pass                          # client went away

        def _one_request(self) -> bool:
            line = self.rfile.readline(65537)
            if not line or line in (b"\r\n", b"\n"):
                return False
            parts = line.split()
            if len(parts) < 2:
                return False
            method, path = parts[0].decode("latin-1"), \
                parts[1].decode("latin-1")
            length, keep = 0, True
            plane: Optional[Dict[str, str]] = None
            while True:
                h = self.rfile.readline(65537)
                if h in (b"\r\n", b"\n", b""):
                    break
                key, _, val = h.partition(b":")
                key = key.strip().lower()
                if key == b"content-length":
                    try:
                        length = int(val)
                    except ValueError:
                        self._reply(
                            400,
                            api.encode_response(api.error_body(api.ApiError(
                                400, "bad Content-Length"))),
                            False)
                        return False
                elif key == b"connection":
                    keep = b"close" not in val.lower()
                elif key in _PLANE_HEADERS:
                    if plane is None:
                        plane = {}
                    plane[key.decode("latin-1")] = \
                        val.strip().decode("latin-1")
            body = self.rfile.read(length) if length else b""
            # the front end's stages of a coalesced route: parse from the
            # body in hand (closed at the coalescer's submit), respond from
            # the dispatcher's release to the last byte written
            clk = None
            if app.stages is not None and method == "POST" and \
                    path.partition("?")[0] in _STAGED_ROUTES:
                clk = app.stages.clock()
                clk.switch(PARSE)
            extra = None
            try:
                status, payload = 200, app.handle(method, path, body, plane)
            except api.ApiError as e:
                status, extra = e.status, e.headers
                payload = api.error_body(e)
            except Exception as e:          # noqa: BLE001 — server boundary
                status = 500
                payload = api.error_body(
                    api.ApiError(500, f"{type(e).__name__}: {e}"))
            if isinstance(payload, api.StreamingResponse):
                return self._stream_reply(payload, keep)
            ctype = "application/json"
            if isinstance(payload, api.PlainTextResponse):
                status, ctype = payload.status, payload.content_type
                data = payload.text.encode("utf-8")
            elif isinstance(payload, api.JsonResponse):
                status = payload.status
                extra = {**payload.headers, **(extra or {})}
                data = api.encode_response(payload.payload)
            else:
                data = api.encode_response(payload)
            try:
                self._reply(status, data, keep, extra, ctype)
            finally:
                if clk is not None:
                    clk.stop()
            return keep

        def _reply(self, status: int, data: bytes, keep: bool,
                   extra: Optional[Dict[str, str]] = None,
                   ctype: str = "application/json") -> None:
            lines = "".join(f"{k}: {v}\r\n" for k, v in (extra or {}).items())
            head = (f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(data)}\r\n"
                    f"{lines}"
                    f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                    f"\r\n").encode("latin-1")
            self.wfile.write(head + data)     # one syscall, one segment

        def _stream_reply(self, resp: api.StreamingResponse,
                          keep: bool) -> bool:
            """Write a token stream as chunked transfer encoding — one
            NDJSON event per chunk, flushed as it decodes, so the client
            sees the first token long before the stream finishes.  A
            failed write means the client went away: cancel the request
            (freeing its decode slot) and drop the connection."""
            lines = "".join(f"{k}: {v}\r\n"
                            for k, v in resp.headers.items())
            head = (f"HTTP/1.1 200 OK\r\n"
                    f"Content-Type: application/x-ndjson\r\n"
                    f"Transfer-Encoding: chunked\r\n"
                    f"{lines}"
                    f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                    f"\r\n").encode("latin-1")
            try:
                self.wfile.write(head)
                for event in resp.events:
                    if app.faults is not None:
                        # "socket_drop": the connection dies mid-stream —
                        # same teardown path as a real failed write
                        app.faults.fire("socket_drop")
                    data = api.encode_response(event) + b"\n"
                    # chunk = size line + payload (wfile is unbuffered:
                    # one write, one segment — the flush per token)
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.write(b"0\r\n\r\n")
                return keep
            except InjectedFault:
                resp.disconnect()             # cancel: free the decode slot
                try:
                    self.connection.close()
                except OSError:
                    pass
                return False
            except (ConnectionError, TimeoutError, OSError):
                resp.disconnect()             # cancel: free the decode slot
                return False

    return Handler


class _ThreadingServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class FlexServeServer:
    """Owns the listening socket; ``start()`` serves on a daemon thread."""

    def __init__(self, app: FlexServeApp, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self.httpd = _ThreadingServer((host, port), make_handler(app))

    @property
    def address(self):
        return self.httpd.server_address

    def start(self, wait_ready: bool = True,
              timeout: float = 10.0) -> "FlexServeServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        if wait_ready:
            self.wait_ready(timeout)
        return self

    def wait_ready(self, timeout: float = 10.0) -> bool:
        """Poll GET /healthz over real HTTP until the endpoint reports
        ready (the same probe an orchestrator would use); returns whether
        readiness was observed within the timeout."""
        host, port = self.address
        client = FlexServeClient(host, port, timeout=max(timeout, 1.0))
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                try:
                    client.healthz()
                    return True
                except (RuntimeError, OSError):
                    time.sleep(0.02)
        finally:
            client.close()
        return False

    def stop(self) -> None:
        self.app._closing = True
        self.httpd.shutdown()
        self.httpd.server_close()
        self.app.close()
