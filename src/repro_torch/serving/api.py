"""REST API schema (kept byte-compatible with the paper's response format).

The routes the PyTorch port serves so far; the request and response bodies
are those of the JAX package's ``repro/serving/api.py``.

POST /v1/infer     {"inputs": {"tokens": [[...], ...]}, "policy": "soft_vote"}
    -> {"model_0": ["class_a", ...], "model_1": [...], "ensemble": [...],
        "policy": "soft_vote"}                                  (paper §2.3)

POST /v1/detect    {"inputs": {...}, "positive_class": 3, "policy": "or",
                    "threshold": 0.5}
    -> {"model_0": [true, false, ...], ..., "ensemble": [...]}   (paper §2.1)

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
GET  /healthz      -> 200 {"status": "ready", "models": n, "coalescing": b}
                      | 503 {"error": ...}
GET  /metrics      -> {"uptime_s", "started_unix", "requests", "routes",
                       "coalesce": {...}, "ensemble_compiles": {...},
                       "admission": {...}}  (JSON only)

The routes of planes not ported yet (/v1/generate, /v1/engines,
/v1/replicas, /v1/models/{name}, /v1/trace, /v1/traces, /v1/usage,
/v1/slo, /v1/debug/profile, /metrics?format=prometheus) answer 501 with
code "not_ported".
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

import torch


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


def parse_request(body: bytes) -> Dict[str, Any]:
    try:
        obj = json.loads(body or b"{}")
    except json.JSONDecodeError as e:
        raise ApiError(400, f"invalid JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ApiError(400, "request body must be a JSON object")
    return obj


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
