"""REST API schema (kept byte-compatible with the paper's response format).

The routes the PyTorch port serves; the request and response bodies are
those of the JAX package's ``repro/serving/api.py``.

POST /v1/infer     {"inputs": {"tokens": [[...], ...]}, "policy": "soft_vote",
                    "target": "canary"?}
    -> {"model_0": ["class_a", ...], "model_1": [...], "ensemble": [...],
        "policy": "soft_vote"}                                  (paper §2.3)

POST /v1/detect    {"inputs": {...}, "positive_class": 3, "policy": "or",
                    "threshold": 0.5, "target": "stable"?}
    -> {"model_0": [true, false, ...], ..., "ensemble": [...]}   (paper §2.1)

``target`` (optional) names a version alias maintained by the lifecycle
manager; requests without one hit the default ("stable") alias.

Request plane (every inference route; all fields optional): "priority"
("interactive" | "bulk"), "deadline_ms", "client", "trace_id", or the
headers ``X-FlexServe-Priority``, ``X-FlexServe-Deadline-Ms``,
``X-FlexServe-Client``, ``X-Request-Id`` (body wins).  Budgets are charged
in rows; a full queue answers 429 with ``Retry-After``, a missed deadline
504.

Every non-2xx response body is the structured error taxonomy:
    {"error": {"code": ..., "message": str, "retryable": bool,
               "trace_id": str|null}}

GET  /v1/models    -> {"models": [{name, version, arch, family, params,
                                   source}, ...], "ensemble_size": n}
GET  /health       -> {"status": "ok", "requests": n}
GET  /healthz      -> 200 {"status": "ready", "models": n, "coalescing": b,
                            "replicas": {"count", "ready", "cordoned"}}
                      | 503 {"error": ...} (also with zero ready replicas)
GET  /metrics      -> {"uptime_s", "started_unix", "requests", "routes",
                       "coalesce": {...}, "ensemble_compiles": {...},
                       "ensemble_batches": {...}, "stages": {...},
                       "lifecycle": {...}, "generate": {...},
                       "admission": {...}, "replicas": {...},
                       "faults": {...}, "usage": {...}, "slo": {...},
                       "telemetry": {...}}
GET  /metrics?format=prometheus -> the same document as Prometheus text
                      exposition (one gauge per numeric leaf, histograms as
                      histogram families)

POST /v1/generate  {"prompts": [[...], ...], "max_new_tokens": 16,
                    "temperature": 0.0, "top_k": 0, "top_p": 1.0,
                    "seed": null, "stop": [], "eos_id": null,
                    "speculation": true}
    -> {"outputs": [[...], ...], "steps": n, "prompt_lengths": [...],
        "finish_reasons": ["length" | "eos" | "stop" | ...]}
    with "stream": true (exactly one prompt): chunked
    application/x-ndjson, one event per chunk:
        {"event": "token", "token": t, "index": i}
        {"event": "done", "tokens": [...], "finish_reason": ...,
         "token_count": n, "prompt_length": ..., "ttft_ms": ...,
         "total_ms": ..., "engine": "name@vN", "sampling": {...},
         "speculation": {"proposed", "accepted", "acceptance_rate"},
         "trace_id": ...}
    or a terminal {"event": "error", "error": ...}.  The generate plane is
    budgeted in tokens (prompt + max_new_tokens).  ``"speculation": false``
    opts a request out of speculative decoding (a no-op on a plain
    engine); the tokens are the same either way, and the terminal
    ``speculation`` summary is zeros for an opted-out request or a plain
    engine.

GET  /v1/replicas  -> {"enabled", "count", "ready", ..., "per_replica"}
POST /v1/replicas/{id}/cordon {"reason": ...} | .../uncordon
                   -> the replica's state (409 without a replica pool)

Every request-plane response carries ``X-Request-Id`` (tracing on):
GET  /v1/trace/{id} -> the request's timeline: spans (http_parse,
                      coalesce_queue, coalesce_forward, queue_wait,
                      prefill, ...), events (admitted, scheduler_queued,
                      first_token, ...), counters (decode_ticks, ...) and
                      attrs (the serving "version")
GET  /v1/traces?limit=&status=&client=&min_duration_ms=
                   -> {"telemetry", "in_flight", "recent": [...]}
GET  /v1/usage?client=&version= -> per-client / per-version cost rollup
GET  /v1/slo?window_s= -> policies, live evaluation, decision audit
GET|POST /v1/debug/profile {"duration_ms", "mode": "auto"|"torch"|"python"}
                   -> 202 + artifact path; GET the capture's status
                      (503 without a profile directory)

Lifecycle admin (a store-backed endpoint; 503 without a manager):
GET  /v1/models/{name}                 manifests, loaded and active versions
POST /v1/models/{name}/load {"version", "alias", "warm"}
POST /v1/models/{name}/unload {"version"?}
POST /v1/models/{name}/rollback {"alias"?}
POST /v1/models/{name}/gc {"keep_last_n"}
GET  /v1/engines                       engine aliases
POST /v1/engines/{name}/load {"version", "alias", "warm", "draft"?,
                              "draft_version"?, "max_window"?}
                                       ("draft" loads a speculative pair)
POST /v1/engines/{name}/rollback {"alias"?}
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

import torch

from repro_torch.core.sampling import SamplingError, SamplingParams


# status -> (default error code, retryable) for the structured error
# taxonomy: every non-2xx body is {"error": {code, message, retryable,
# trace_id}} and clients retry ONLY retryable codes (instead of
# string-matching on the status line)
_STATUS_CODES: Dict[int, "tuple[str, bool]"] = {
    400: ("bad_request", False),
    403: ("forbidden", False),
    404: ("not_found", False),
    405: ("method_not_allowed", False),
    408: ("timeout", True),
    409: ("conflict", False),
    413: ("payload_too_large", False),
    429: ("queue_full", True),
    499: ("client_closed", False),
    500: ("internal", False),
    501: ("not_implemented", False),
    503: ("unavailable", True),
    504: ("deadline_exceeded", False),
}


def default_error_code(status: int) -> "tuple[str, bool]":
    """(code, retryable) defaults for a bare status."""
    if status in _STATUS_CODES:
        return _STATUS_CODES[status]
    if 400 <= status < 500:
        return "bad_request", False
    return "internal", False


class ApiError(Exception):
    """Route-layer failure; ``headers`` carries extras like Retry-After.

    ``code``/``retryable`` feed the structured error taxonomy; both
    default from the status so existing ``raise ApiError(...)`` sites
    stay correct without changes."""

    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None,
                 code: Optional[str] = None,
                 retryable: Optional[bool] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}
        d_code, d_retry = default_error_code(status)
        self.code = code if code is not None else d_code
        self.retryable = retryable if retryable is not None else d_retry


def error_body(err: ApiError,
               trace_id: Optional[str] = None) -> Dict[str, Any]:
    """The structured non-2xx body: every error response carries a
    machine-readable code, whether a retry can help, and the trace id to
    pull the request's timeline."""
    return {"error": {
        "code": err.code,
        "message": err.message,
        "retryable": err.retryable,
        "trace_id": trace_id or err.headers.get("X-Request-Id"),
    }}


class JsonResponse:
    """A JSON payload plus extra response headers and a status other than
    200.  Route handlers that return a bare dict get the defaults."""

    def __init__(self, payload: Dict[str, Any],
                 headers: Optional[Dict[str, str]] = None,
                 status: int = 200):
        self.payload = payload
        self.headers = headers or {}
        self.status = status


class PlainTextResponse:
    """A non-JSON body."""

    def __init__(self, text: str,
                 content_type: str = "text/plain; version=0.0.4; "
                                     "charset=utf-8",
                 status: int = 200):
        self.text = text
        self.content_type = content_type
        self.status = status


class StreamingResponse:
    """A route handler's signal to the HTTP layer: write ``events`` as a
    chunked-transfer NDJSON body (one event per chunk) instead of a single
    JSON document.  ``on_disconnect`` is invoked if the client goes away
    mid-stream (cancels the underlying request)."""

    def __init__(self, events: Iterator[Dict[str, Any]],
                 on_disconnect: Optional[Callable[[], Any]] = None,
                 headers: Optional[Dict[str, str]] = None):
        self.events = events
        self.headers: Dict[str, str] = headers or {}
        self._on_disconnect = on_disconnect

    def disconnect(self) -> None:
        if self._on_disconnect is not None:
            self._on_disconnect()


def parse_sampling(req: Dict[str, Any], *,
                   default_max_new_tokens: int = 16) -> SamplingParams:
    """Per-request sampling params from a /v1/generate body (400 on bad)."""
    try:
        return SamplingParams.from_request(
            req, default_max_new_tokens=default_max_new_tokens)
    except SamplingError as e:
        raise ApiError(400, str(e)) from None


def parse_request(body: bytes) -> Dict[str, Any]:
    try:
        obj = json.loads(body or b"{}")
    except json.JSONDecodeError as e:
        raise ApiError(400, f"invalid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ApiError(400, "request body must be a JSON object")
    return obj


def opt_int(req: Dict[str, Any], key: str, default: int) -> int:
    """Integer field with a 400 (not a 500) on malformed values."""
    val = req.get(key, default)
    try:
        return int(val)
    except (TypeError, ValueError):
        raise ApiError(400, f"{key!r} must be an integer, "
                            f"got {val!r}") from None


def to_jsonable(obj):
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return to_jsonable(obj.tolist())
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.is_floating_point():
            t = t.float()                 # numpy has no bfloat16
        return to_jsonable(t.numpy())
    return obj


def encode_response(obj: Dict[str, Any]) -> bytes:
    return json.dumps(to_jsonable(obj)).encode()


def inputs_to_batch(inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
    if not isinstance(inputs, dict) or not inputs:
        raise ApiError(400, "'inputs' must be a non-empty object of arrays")
    batch = {}
    n = None
    for k, v in inputs.items():
        arr = np.asarray(v)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        if n is None:
            n = arr.shape[0]
        elif arr.shape[0] != n:
            raise ApiError(400, "all inputs must share the batch dimension")
        batch[k] = arr
    return batch
