"""FlexServe REST server — a lean thread-per-connection HTTP front-end.

The port of ``repro/serving/server.py`` for the paper's own path.  A
threaded front-end accepts concurrent client connections, with a
hand-rolled keep-alive HTTP/1.1 handler.  Ensemble routes (/v1/infer,
/v1/detect) funnel through a ``BatchCoalescer`` that merges concurrent
requests' rows into one bucketed forward on the card; /v1/generate goes
through a ``GenerationService`` that admits prompts into continuous-
batching decode slots (blocking, or streamed as chunked NDJSON), optionally
behind a health-checked ``ReplicaPool`` with failover.  ``coalesce=False``
runs one request per forward behind a device lock instead.

Routes of the planes not ported yet (lifecycle admin, engines, traces,
usage, SLO, profiler) answer 501 with a structured error body that says
so.  Endpoints are defined in ``repro_torch.serving.api``.
"""

from __future__ import annotations

import socketserver
import threading
import time
import urllib.parse
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.engine import InferenceEngine
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.faults import (ZERO_FAULT_STATS, FaultInjector,
                                     InjectedFault)
from repro_torch.core.registry import ModelRegistry
from repro_torch.serving import api
from repro_torch.serving.admission import (AdmissionController, DeadlineError,
                                           RequestContext, ShedError)
from repro_torch.serving.client import FlexServeClient
from repro_torch.serving.coalesce import BatchCoalescer
from repro_torch.serving.generate import GenerationError, GenerationService
from repro_torch.serving.replica import ZERO_REPLICA_STATS

# route prefix -> the plane that serves it in the JAX package
_NOT_PORTED = (
    ("/v1/engines", "generate-engine lifecycle"),
    ("/v1/models/", "model lifecycle admin"),
    ("/v1/trace", "tracing"),
    ("/v1/usage", "usage accounting"),
    ("/v1/slo", "SLO autopilot"),
    ("/v1/debug/profile", "profiler"),
)


def not_ported(plane: str) -> api.ApiError:
    return api.ApiError(
        501, f"the {plane} plane is not ported to the PyTorch package yet "
             f"(see ROADMAP.md, section 1)", code="not_ported")


class FlexServeApp:
    """Bundles a registry, an ensemble and a generation engine behind the
    request plane.

    ``max_wait_ms`` / ``max_coalesce_rows`` tune the coalescer (how long
    the dispatcher lingers for more rows — ``None`` derives the linger
    adaptively from the observed arrival rate — and the rows-per-forward
    cap); ``max_queue``, ``bulk_fraction`` and ``default_deadline_ms`` tune
    admission; ``num_slots`` sizes the continuous-batching decode pool and
    ``generate_token_budget`` the generate plane's admission budget in
    tokens (default ``32 * max_queue``).

    ``replicas > 1`` runs the generate plane as a health-checked
    ``ReplicaPool`` — N decode schedulers over the one engine, with
    automatic cordon/restart and transparent failover (GET /v1/replicas).
    ``fault_config`` accepts anything ``FaultInjector.load`` does (path /
    dict / injector) and arms the deterministic chaos sites of the
    scheduler drivers, the pool and the stream writer;
    ``replica_options`` passes pool tuning knobs (health thresholds)
    straight through."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 ensemble: Optional[Ensemble] = None,
                 engine: Optional[InferenceEngine] = None, *,
                 coalesce: bool = True,
                 max_wait_ms: Optional[float] = None,
                 max_coalesce_rows: Optional[int] = None,
                 num_slots: int = 4,
                 max_queue: int = 64,
                 bulk_fraction: float = 0.5,
                 default_deadline_ms: Optional[float] = None,
                 max_stream_buffer: int = 32,
                 generate_token_budget: Optional[int] = None,
                 client_weights: Optional[Dict[str, float]] = None,
                 replicas: int = 1,
                 fault_config: Any = None,
                 replica_options: Optional[Dict[str, Any]] = None):
        # one injector shared by every layer (scheduler drivers, the
        # replica monitor, the stream writer) so a single config file
        # describes the whole chaos drill
        self.faults: Optional[FaultInjector] = FaultInjector.load(
            fault_config)
        self.registry = registry or ModelRegistry()
        self.ensemble = ensemble
        self.engine = engine
        self.device_lock = threading.Lock()
        self.request_count = 0
        # monotonic for uptime arithmetic; the wall time is only reported
        self._t0 = time.monotonic()
        self._started_unix = time.time()
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
        if coalesce and ensemble is not None:
            self.coalescer = BatchCoalescer(
                ensemble.forward, ensemble.batch_buckets,
                max_wait_ms=max_wait_ms, max_rows=max_coalesce_rows)
        if coalesce and engine is not None:
            self.generation = GenerationService(
                engine, num_slots=num_slots,
                max_pending=max(num_slots, max_queue),
                max_stream_buffer=max_stream_buffer,
                client_weights=client_weights,
                num_replicas=replicas,
                faults=self.faults,
                replica_options=replica_options)

    def close(self) -> None:
        """Stop background dispatch and driver threads (idempotent)."""
        self._closing = True
        if self.coalescer is not None:
            self.coalescer.close()
            self.coalescer = None
        if self.generation is not None:
            self.generation.close()
            self.generation = None

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
        if (self.ensemble is None and self.engine is None
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

    def handle(self, method: str, path: str, body: bytes,
               headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        with self._stats_lock:
            self.request_count += 1
        t0 = time.perf_counter()
        try:
            return self._route(method, path, body, headers, t0)
        finally:
            dt = time.perf_counter() - t0
            key = f"{method} {path.partition('?')[0]}"
            with self._stats_lock:
                st = self._route_stats.setdefault(
                    key, {"count": 0, "total_s": 0.0, "max_s": 0.0})
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
            fmt = query.get("format", "json")
            if fmt == "prometheus":
                raise not_ported("Prometheus exposition")
            if fmt != "json":
                raise api.ApiError(400, f"unknown metrics format {fmt!r}")
            return self._metrics()
        if method == "GET" and path == "/v1/models":
            return {"models": self.registry.describe(),
                    "ensemble_size": (len(self.ensemble.members)
                                      if self.ensemble else 0)}
        if method == "POST" and path == "/v1/infer":
            return self._request("infer", body, headers, arrival)
        if method == "POST" and path == "/v1/detect":
            return self._request("detect", body, headers, arrival)
        if method == "POST" and path == "/v1/generate":
            return self._request("generate", body, headers, arrival)
        if method == "GET" and path == "/v1/replicas":
            return self._replicas_status(query)
        if path.startswith("/v1/replicas/"):
            return self._replica_admin(method,
                                       path[len("/v1/replicas/"):], body)
        for prefix, plane in _NOT_PORTED:
            if path.startswith(prefix):
                raise not_ported(plane)
        raise api.ApiError(404, f"no route {method} {path}")

    def _metrics(self) -> Dict[str, Any]:
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
        if self.generation is not None:
            out["generate"] = self.generation.stats()
        out["admission"] = self.admission.stats()
        # always present (zeroed when off) so the /metrics schema is
        # stable across configs
        out["replicas"] = (self.generation.replica_summary()
                           if self.generation is not None
                           else dict(ZERO_REPLICA_STATS))
        out["faults"] = (self.faults.stats() if self.faults is not None
                         else dict(ZERO_FAULT_STATS))
        return out

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

    # --- request plane --------------------------------------------------------

    def _request(self, plane: str, body: bytes,
                 headers: Optional[Dict[str, str]],
                 arrival: Optional[float]):
        req = api.parse_request(body)
        try:
            ctx = self.admission.context(req, headers, arrival_s=arrival)
        except ValueError as e:
            raise api.ApiError(400, str(e)) from None
        route = {"infer": self._infer, "detect": self._detect,
                 "generate": self._generate}[plane]
        return route(req, ctx)

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

    def _require_ensemble(self, alias: Optional[str] = None) -> Ensemble:
        if alias is not None:
            raise api.ApiError(
                400, "per-request 'target' aliases need a lifecycle "
                     "manager on this endpoint")
        if self.ensemble is None:
            raise api.ApiError(503, "no ensemble deployed on this endpoint")
        return self.ensemble

    def _ensemble_logits(self, batch,
                         ctx: RequestContext) -> Dict[str, np.ndarray]:
        """One forward's worth of per-member logits for this request's rows —
        coalesced with concurrent requests of the same signature when the
        coalescer is on.  Admission is charged per ROW; a missed deadline
        surfaces as 504, a full queue as 429."""
        ens = self._require_ensemble()
        rows = next(iter(batch.values())).shape[0]
        ticket = self._admit("infer", ctx, rows)
        try:
            if self.coalescer is not None:
                return self.coalescer.submit(batch, ctx=ctx)
            with self.device_lock:
                if ctx.expired():
                    raise DeadlineError(
                        "deadline exceeded waiting for the device lock")
                return ens.forward(batch)
        except DeadlineError as e:
            self.admission.deadline_miss(
                "infer", "coalesce" if self.coalescer is not None
                else "device_lock")
            raise api.ApiError(504, str(e)) from None
        except (KeyError, ValueError) as e:
            raise api.ApiError(400, str(e)) from None
        finally:
            ticket.release()

    def _infer(self, req, ctx: RequestContext) -> Dict[str, Any]:
        ens = self._require_ensemble(req.get("target"))
        batch = api.inputs_to_batch(req.get("inputs", {}))
        policy = req.get("policy", "soft_vote")
        logits = self._ensemble_logits(batch, ctx)
        try:
            return ens.respond_from_logits(logits, policy=policy)
        except (KeyError, ValueError) as e:
            raise api.ApiError(400, str(e)) from None

    def _detect(self, req, ctx: RequestContext) -> Dict[str, Any]:
        ens = self._require_ensemble(req.get("target"))
        batch = api.inputs_to_batch(req.get("inputs", {}))
        if "positive_class" not in req:
            raise api.ApiError(400, "'positive_class' is required")
        logits = self._ensemble_logits(batch, ctx)
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
            self._reply(status, data, keep, extra, ctype)
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
