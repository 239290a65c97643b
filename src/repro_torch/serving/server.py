"""FlexServe REST server — a lean thread-per-connection HTTP front-end.

The port of ``repro/serving/server.py`` for the paper's own path.  A
threaded front-end accepts concurrent client connections, with a
hand-rolled keep-alive HTTP/1.1 handler.  Ensemble routes (/v1/infer,
/v1/detect) funnel through a ``BatchCoalescer`` that merges concurrent
requests' rows into one bucketed forward on the card; ``coalesce=False``
runs one request per forward behind a device lock instead.

Routes of the planes not ported yet (generate, lifecycle admin, engines,
replicas, traces, usage, SLO, profiler) answer 501 with a structured
error body that says so.  Endpoints are defined in
``repro_torch.serving.api``.
"""

from __future__ import annotations

import http.client
import socketserver
import threading
import time
import urllib.parse
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.core.ensemble import Ensemble
from repro_torch.core.registry import ModelRegistry
from repro_torch.serving import api
from repro_torch.serving.admission import (AdmissionController, DeadlineError,
                                           RequestContext, ShedError)
from repro_torch.serving.coalesce import BatchCoalescer

# route prefix -> the plane that serves it in the JAX package
_NOT_PORTED = (
    ("/v1/generate", "generate"),
    ("/v1/engines", "generate-engine lifecycle"),
    ("/v1/replicas", "replica pool"),
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
    """Bundles a registry and an ensemble behind the request plane.

    ``max_wait_ms`` / ``max_coalesce_rows`` tune the coalescer (how long
    the dispatcher lingers for more rows — ``None`` derives the linger
    adaptively from the observed arrival rate — and the rows-per-forward
    cap); ``max_queue``, ``bulk_fraction`` and ``default_deadline_ms`` tune
    admission."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 ensemble: Optional[Ensemble] = None, *,
                 coalesce: bool = True,
                 max_wait_ms: Optional[float] = None,
                 max_coalesce_rows: Optional[int] = None,
                 max_queue: int = 64,
                 bulk_fraction: float = 0.5,
                 default_deadline_ms: Optional[float] = None):
        self.registry = registry or ModelRegistry()
        self.ensemble = ensemble
        self.device_lock = threading.Lock()
        self.request_count = 0
        # monotonic for uptime arithmetic; the wall time is only reported
        self._t0 = time.monotonic()
        self._started_unix = time.time()
        self._closing = False
        self._route_stats: Dict[str, Dict[str, float]] = {}
        self._stats_lock = threading.Lock()
        self.admission = AdmissionController(
            max_queue=max_queue, bulk_fraction=bulk_fraction,
            default_deadline_ms=default_deadline_ms)
        self.coalescer: Optional[BatchCoalescer] = None
        if coalesce and ensemble is not None:
            self.coalescer = BatchCoalescer(
                ensemble.forward, ensemble.batch_buckets,
                max_wait_ms=max_wait_ms, max_rows=max_coalesce_rows)

    def close(self) -> None:
        """Stop the coalescer's dispatch thread (idempotent)."""
        self._closing = True
        if self.coalescer is not None:
            self.coalescer.close()
            self.coalescer = None

    # --- readiness ------------------------------------------------------------

    def ready(self) -> Dict[str, Any]:
        """Readiness probe payload; raises 503 while not servable."""
        if self._closing:
            raise api.ApiError(503, "shutting down")
        if self.coalescer is not None and not self.coalescer.alive:
            raise api.ApiError(503, "coalescer dispatch thread not alive")
        if self.ensemble is None and len(self.registry) == 0:
            raise api.ApiError(503, "no models loaded yet")
        return {"status": "ready", "models": len(self.registry),
                "coalescing": self.coalescer is not None}

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
        out["admission"] = self.admission.stats()
        return out

    # --- request plane --------------------------------------------------------

    def _request(self, plane: str, body: bytes,
                 headers: Optional[Dict[str, str]],
                 arrival: Optional[float]) -> Dict[str, Any]:
        req = api.parse_request(body)
        try:
            ctx = self.admission.context(req, headers, arrival_s=arrival)
        except ValueError as e:
            raise api.ApiError(400, str(e)) from None
        return (self._infer if plane == "infer" else self._detect)(req, ctx)

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
        try:
            ticket = self.admission.admit("infer", ctx, rows)
        except ShedError as e:
            raise api.ApiError(
                429, str(e),
                headers={"Retry-After": format(e.retry_after_s, ".3f")}
            ) from None
        except DeadlineError as e:
            raise api.ApiError(504, str(e)) from None
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


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            429: "Too Many Requests", 500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable",
            504: "Gateway Timeout"}

# request-plane headers the lean parser captures (already lowercase)
_PLANE_HEADERS = (b"x-flexserve-priority", b"x-flexserve-deadline-ms",
                  b"x-flexserve-client", b"x-request-id")


def make_handler(app: FlexServeApp):
    class Handler(socketserver.StreamRequestHandler):
        """Lean HTTP/1.1 keep-alive handler: request line, Content-Length,
        Connection and the request-plane headers; the response goes out as
        ONE write (no Nagle/delayed-ACK stalls when a coalesced batch
        releases many responses at once)."""

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
            self._reply(status, api.encode_response(payload), keep, extra)
            return keep

        def _reply(self, status: int, data: bytes, keep: bool,
                   extra: Optional[Dict[str, str]] = None) -> None:
            lines = "".join(f"{k}: {v}\r\n" for k, v in (extra or {}).items())
            head = (f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
                    f"Content-Type: application/json\r\n"
                    f"Content-Length: {len(data)}\r\n"
                    f"{lines}"
                    f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                    f"\r\n").encode("latin-1")
            self.wfile.write(head + data)     # one syscall, one segment

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
        ready; returns whether readiness was observed in time."""
        host, port = self.address
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            conn = http.client.HTTPConnection(host, port, timeout=1.0)
            try:
                conn.request("GET", "/healthz")
                if conn.getresponse().status == 200:
                    return True
            except OSError:
                pass
            finally:
                conn.close()
            time.sleep(0.02)
        return False

    def stop(self) -> None:
        self.app._closing = True
        self.httpd.shutdown()
        self.httpd.server_close()
        self.app.close()
