"""Minimal HTTP client for FlexServe endpoints (raw sockets): the port's
copy of ``repro/serving/client.py`` (standard library only).

Connections are persistent (HTTP/1.1 keep-alive) and thread-local: each
client thread reuses one TCP connection across requests, with TCP_NODELAY
so small request/response bodies are never Nagle-stalled.  Requests go out
as ONE send; responses are parsed with a minimal header scan (status +
Content-Length / Transfer-Encoding) — the same leanness as the server
side, so concurrent benchmarking measures the endpoint, not stdlib HTTP
machinery.  A stale connection (server restart, timeout) is transparently
re-opened once.

Streaming: ``generate_stream`` issues a ``"stream": true`` generate and
returns an iterator of JSON events, parsed incrementally from the chunked
response as the server flushes each token.  The iterator must be consumed
to the terminal ("done"/"error") event to keep the connection reusable;
``close()`` abandons a stream mid-flight (the server notices the
disconnect and cancels the request).

Resilience: every non-2xx body carries the server's structured error
taxonomy (``{"error": {"code", "message", "retryable", "trace_id"}}``).
The client raises a TYPED error keyed off ``code`` (``QueueFullError``,
``UnavailableError``, ...) and retries exactly the errors the server
marked ``retryable`` — with capped exponential backoff plus jitter,
honoring the ``Retry-After`` hint when present.  Unstructured bodies
(older servers, proxies) fall back to the status-based
``retry_statuses`` list.  Delivery metadata rides on the response object
(``resp.attempts``).  Probe routes (``health``/``healthz``) never retry:
they exist to OBSERVE the 503.

Hedging (off by default): construct with ``hedge_ms=<float>`` or
``hedge_ms="p95"`` and the idempotent unary routes (``infer``,
``detect``) fire a BACKUP copy of any request still unanswered after the
hedge delay, on its own connection; the first response wins and the
loser's connection is torn down (the server sees a disconnect).  This
trades duplicate work for tail latency — classic tail-at-scale hedging.
"""

from __future__ import annotations

import collections
import datetime
import email.utils
import json
import math
import queue
import random
import socket
import threading
import time
import urllib.parse
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple


def parse_retry_after(val: bytes) -> Optional[float]:
    """Lenient ``Retry-After`` parse -> non-negative seconds, or None.

    RFC 9110 allows two forms: delta-seconds and an HTTP-date.  The old
    ``float(val)`` parse discarded the date form entirely and — worse —
    accepted ``nan``/``inf``/negatives, which poisoned the backoff math
    (``time.sleep(nan)`` raises mid-retry).  Anything unusable returns
    None and the client falls back to capped exponential backoff."""
    text = val.strip().decode("latin-1", "replace")
    if not text:
        return None
    try:
        secs = float(text)
    except ValueError:
        try:
            when = email.utils.parsedate_to_datetime(text)
        except (TypeError, ValueError):
            return None
        if when is None:
            return None
        if when.tzinfo is None:
            when = when.replace(tzinfo=datetime.timezone.utc)
        secs = when.timestamp() - time.time()
    if math.isnan(secs) or math.isinf(secs):
        return None
    return max(0.0, secs)


class HTTPStatusError(RuntimeError):
    """Non-200 response after any retries.

    Carries the status code plus the server's structured error fields:
    ``code`` (machine-readable taxonomy entry), ``retryable`` (whether
    the server says a retry can help), ``trace_id`` (for ``trace()``),
    and ``structured`` (False when the body wasn't a taxonomy body —
    the retry decision then falls back to ``retry_statuses``)."""

    def __init__(self, status: int, message: str,
                 retry_after_s: Optional[float] = None, *,
                 code: Optional[str] = None,
                 retryable: bool = False,
                 trace_id: Optional[str] = None,
                 structured: bool = False):
        super().__init__(message)
        self.status = status
        self.retry_after_s = retry_after_s
        self.code = code or "internal"
        self.retryable = retryable
        self.trace_id = trace_id
        self.structured = structured


class BadRequestError(HTTPStatusError):
    """``code: bad_request`` — the request itself is malformed."""


class NotFoundError(HTTPStatusError):
    """``code: not_found`` — unknown route/model/alias/trace."""


class ConflictError(HTTPStatusError):
    """``code: conflict`` — state precondition failed (409)."""


class QueueFullError(HTTPStatusError):
    """``code: queue_full`` — admission shed the request (retryable)."""


class RequestTimeoutError(HTTPStatusError):
    """``code: timeout`` — the server timed the request out (408)."""


class ClientClosedError(HTTPStatusError):
    """``code: client_closed`` — the server recorded a client abort."""


class UnavailableError(HTTPStatusError):
    """``code: unavailable`` — endpoint not servable right now
    (startup, hot swap, zero ready replicas); retryable."""


class DeadlineExceededError(HTTPStatusError):
    """``code: deadline_exceeded`` — the request's own deadline passed
    before the work finished; retrying cannot help THIS deadline."""


class InternalServerError(HTTPStatusError):
    """``code: internal`` — unexpected server-side failure."""


# taxonomy code -> typed error class (unknown codes raise the base class)
ERROR_TYPES: Dict[str, type] = {
    "bad_request": BadRequestError,
    "not_found": NotFoundError,
    "conflict": ConflictError,
    "queue_full": QueueFullError,
    "timeout": RequestTimeoutError,
    "client_closed": ClientClosedError,
    "unavailable": UnavailableError,
    "deadline_exceeded": DeadlineExceededError,
    "internal": InternalServerError,
}

# status -> (code, retryable) fallback for unstructured bodies; mirrors
# the server-side taxonomy so old/new clients classify identically
_STATUS_FALLBACK: Dict[int, Tuple[str, bool]] = {
    400: ("bad_request", False), 404: ("not_found", False),
    405: ("not_found", False), 408: ("timeout", True),
    409: ("conflict", False), 413: ("bad_request", False),
    429: ("queue_full", True), 499: ("client_closed", False),
    500: ("internal", False), 501: ("internal", False),
    503: ("unavailable", True), 504: ("deadline_exceeded", False),
}


def make_error(status: int, raw: bytes, retry_after: Optional[float],
               trace_id: Optional[str], context: str) -> HTTPStatusError:
    """Parse a non-2xx body into the right typed error.  A structured
    ``{"error": {...}}`` taxonomy body supplies code/retryable/trace_id
    directly; anything else (legacy flat ``{"error": "msg"}``, proxies,
    empty bodies) falls back to the status map with
    ``structured=False``."""
    try:
        data = json.loads(raw or b"{}")
    except ValueError:
        data = {}
    err = data.get("error") if isinstance(data, dict) else None
    f_code, f_retry = _STATUS_FALLBACK.get(
        status, ("bad_request" if 400 <= status < 500 else "internal",
                 False))
    if isinstance(err, dict) and "code" in err:
        code = str(err["code"])
        message = str(err.get("message", ""))
        retryable = bool(err.get("retryable", f_retry))
        trace_id = err.get("trace_id") or trace_id
        structured = True
    else:
        code, retryable, structured = f_code, f_retry, False
        message = str(err if err is not None else (data or raw[:200]))
    cls = ERROR_TYPES.get(code, HTTPStatusError)
    return cls(status, f"{context} -> {status} [{code}]: {message}",
               retry_after, code=code, retryable=retryable,
               trace_id=trace_id, structured=structured)


class Response(dict):
    """A route's JSON payload plus client-side delivery metadata
    (``attempts`` — how many sends it took, 1 when nothing was shed;
    ``trace_id`` — the server's ``X-Request-Id`` echo, usable with
    ``trace()`` to fetch the request's recorded timeline)."""

    attempts: int = 1
    trace_id: Optional[str] = None


class _Connection:
    """One persistent keep-alive connection."""

    def __init__(self, host: str, port: int, timeout: float):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb")

    def close(self) -> None:
        try:
            self.rfile.close()
            self.sock.close()
        except OSError:
            pass

    def _send_and_head(self, request: bytes
                       ) -> Tuple[int, int, bool, Optional[float],
                                  Optional[str]]:
        """Send + parse the response head ->
        (status, length, chunked, retry_after_s, trace_id)."""
        self.sock.sendall(request)
        status_line = self.rfile.readline(65537)
        if not status_line:
            raise ConnectionError("server closed the connection")
        parts = status_line.split(None, 2)
        if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
            raise ConnectionError(f"malformed status line {status_line!r}")
        status = int(parts[1])
        length, chunked, retry_after, trace_id = 0, False, None, None
        while True:
            h = self.rfile.readline(65537)
            if h in (b"\r\n", b"\n", b""):
                break
            key, _, val = h.partition(b":")
            key = key.strip().lower()
            if key == b"content-length":
                length = int(val)
            elif key == b"transfer-encoding":
                chunked = b"chunked" in val.lower()
            elif key == b"retry-after":
                retry_after = parse_retry_after(val)
            elif key == b"x-request-id":
                trace_id = val.strip().decode("latin-1")
        return status, length, chunked, retry_after, trace_id

    def roundtrip(self, request: bytes
                  ) -> Tuple[int, bytes, Optional[float], Optional[str]]:
        status, length, chunked, retry_after, trace_id = \
            self._send_and_head(request)
        if chunked:
            return status, b"".join(self.read_chunks()), retry_after, \
                trace_id
        return (status, self.rfile.read(length) if length else b"",
                retry_after, trace_id)

    def stream(self, request: bytes
               ) -> Tuple[int, Iterator[bytes], Optional[float]]:
        """-> (status, iterator of newline-delimited body records,
        retry_after_s).

        A chunked response is parsed chunk by chunk as the server flushes
        (this is what makes client-side streaming real: each record is
        yielded the moment its chunk arrives); a Content-Length response
        degenerates to a single record.
        """
        status, length, chunked, retry_after, _ = \
            self._send_and_head(request)
        if not chunked:
            body = self.rfile.read(length) if length else b""
            return status, iter([body] if body else []), retry_after
        return status, self._iter_records(), retry_after

    def read_chunks(self) -> Iterator[bytes]:
        """Decode chunked transfer encoding: size-line, payload, CRLF,
        terminated by a zero-size chunk."""
        while True:
            size_line = self.rfile.readline(65537)
            if not size_line:
                raise ConnectionError("truncated chunked response")
            try:
                size = int(size_line.split(b";", 1)[0], 16)
            except ValueError:
                raise ConnectionError(
                    f"malformed chunk size {size_line!r}") from None
            if size == 0:
                self.rfile.readline(65537)        # trailing CRLF
                return
            data = self.rfile.read(size)
            if len(data) < size:
                raise ConnectionError("truncated chunk payload")
            self.rfile.read(2)                    # chunk-terminating CRLF
            yield data

    def _iter_records(self) -> Iterator[bytes]:
        """Split the chunk stream into newline-delimited records,
        tolerating records that span chunk boundaries."""
        buf = b""
        for chunk in self.read_chunks():
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if line.strip():
                    yield line
        if buf.strip():
            yield buf


class FlexServeClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 timeout: float = 60.0, *, retries: int = 3,
                 backoff_s: float = 0.05, max_backoff_s: float = 2.0,
                 retry_statuses: Sequence[int] = (429, 503),
                 hedge_ms: Any = None):
        self.host, self.port, self.timeout = host, port, timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.retry_statuses = tuple(retry_statuses)
        # hedging: None = off, a number = fixed delay in ms, "p95"/"auto"
        # = adapt the delay to the observed per-route p95 latency
        if hedge_ms is not None and not isinstance(hedge_ms, (int, float)) \
                and hedge_ms not in ("p95", "auto"):
            raise ValueError(
                "hedge_ms must be None, a number (ms), 'p95' or 'auto'")
        self.hedge_ms = hedge_ms
        self.hedges = 0                    # backups actually launched
        self.hedge_wins = 0                # ... that beat the primary
        self._latency: Dict[str, "collections.deque"] = {}
        self._local = threading.local()

    def _conn(self) -> _Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = _Connection(self.host, self.port, self.timeout)
            self._local.conn = conn
        return conn

    def close(self) -> None:
        """Close this thread's persistent connection (if any)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def _raw_request(self, method: str, path: str,
                     payload: Optional[Dict[str, Any]] = None) -> bytes:
        body = json.dumps(payload).encode() if payload is not None else b""
        return (f"{method} {path} HTTP/1.1\r\n"
                f"Host: {self.host}:{self.port}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"\r\n").encode("latin-1") + body

    def _roundtrip_once(self, request: bytes
                        ) -> Tuple[int, bytes, Optional[float],
                                   Optional[str]]:
        """One send with the stale-keep-alive reconnect, no status retry."""
        for attempt in (0, 1):
            fresh = getattr(self._local, "conn", None) is None
            try:
                return self._conn().roundtrip(request)
            except socket.timeout:
                # The server may still be processing; resending would
                # execute a non-idempotent POST twice.  Never retry.
                self.close()
                raise
            except (ConnectionError, OSError):
                self.close()
                # A REUSED keep-alive connection dying on first read is the
                # stale-connection case — safe to reconnect once.  A fresh
                # connection failing is a real error.
                if attempt or fresh:
                    raise
        raise ConnectionError("unreachable")

    def _backoff_delay(self, attempt: int,
                       retry_after: Optional[float]) -> float:
        """Server hint when given, else capped exponential; jittered so a
        shed herd does not return in lockstep.  Never sleeps less than
        the hint, never more than ``max_backoff_s`` (the jitter is capped
        too — 'capped' must mean the number in the constructor)."""
        if (retry_after is None or math.isnan(retry_after)
                or retry_after < 0):
            # unusable hint (absent, or hostile header that slipped past
            # parsing): fall back to capped exponential — never let a
            # header value reach time.sleep() unvalidated
            retry_after = None
        base = (retry_after if retry_after is not None
                else self.backoff_s * (2 ** (attempt - 1)))
        base = min(base, self.max_backoff_s)
        return min(base + random.uniform(0, base / 2), self.max_backoff_s)

    def _should_retry(self, err: HTTPStatusError) -> bool:
        """Structured bodies are authoritative — retry iff the server
        says the error is retryable.  Unstructured bodies (legacy
        servers, intermediaries) fall back to the status list."""
        if err.structured:
            return err.retryable
        return err.status in self.retry_statuses

    def _record_latency(self, path: str, dt_s: float) -> None:
        lat = self._latency.get(path)
        if lat is None:
            lat = self._latency.setdefault(
                path, collections.deque(maxlen=256))
        lat.append(dt_s)

    def _hedge_delay_s(self, path: str) -> Optional[float]:
        """The current hedge delay for a route, or None when hedging is
        off.  In "p95" mode the delay tracks the observed per-route p95
        (50 ms until enough samples exist)."""
        if self.hedge_ms is None:
            return None
        if isinstance(self.hedge_ms, (int, float)):
            return max(0.0, float(self.hedge_ms) / 1e3)
        lat = self._latency.get(path)
        if lat is not None and len(lat) >= 8:
            xs = sorted(lat)
            return xs[min(len(xs) - 1, int(0.95 * len(xs)))]
        return 0.05

    def _hedged_roundtrip(self, request: bytes, delay_s: float
                          ) -> Tuple[int, bytes, Optional[float],
                                     Optional[str]]:
        """One logical send with tail-latency hedging: a backup copy
        goes out on its OWN connection if the primary hasn't answered
        within ``delay_s``; the first HTTP response wins and the loser's
        connection is closed (the server observes a disconnect and, on
        streaming-free unary routes, simply wastes one forward).  Both
        attempts use dedicated connections so the thread-local keep-alive
        connection never ends up with an orphaned in-flight response."""
        results: "queue.Queue[Tuple[str, Any, Any]]" = queue.Queue()
        conns: Dict[str, _Connection] = {}
        state = {"done": False}

        def attempt(role: str) -> None:
            conn = None
            try:
                conn = _Connection(self.host, self.port, self.timeout)
                conns[role] = conn
                results.put((role, conn.roundtrip(request), None))
            except BaseException as e:      # noqa: BLE001 — reported below
                results.put((role, None, e))
            finally:
                # covers the race where the loser's connection is created
                # after the winner's teardown sweep ran
                if conn is not None and state["done"]:
                    conn.close()

        threading.Thread(target=attempt, args=("primary",),
                         daemon=True).start()
        pending, backup_started = 1, False
        winner = None
        first_exc: Optional[BaseException] = None
        try:
            while pending:
                if not backup_started:
                    try:
                        role, out, exc = results.get(timeout=delay_s)
                    except queue.Empty:
                        backup_started = True
                        self.hedges += 1
                        threading.Thread(target=attempt, args=("backup",),
                                         daemon=True).start()
                        pending += 1
                        continue
                else:
                    role, out, exc = results.get()
                pending -= 1
                if exc is None:
                    winner = (role, out)
                    break
                first_exc = first_exc or exc
            if winner is None:
                raise first_exc or ConnectionError("hedge: no attempts ran")
            if winner[0] == "backup":
                self.hedge_wins += 1
            return winner[1]
        finally:
            state["done"] = True
            for conn in list(conns.values()):
                conn.close()

    def _request(self, method: str, path: str,
                 payload: Optional[Dict[str, Any]] = None, *,
                 retries: Optional[int] = None,
                 ok: Tuple[int, ...] = (200,),
                 hedge: bool = False) -> Response:
        request = self._raw_request(method, path, payload)
        retries = self.retries if retries is None else retries
        attempts = 0
        while True:
            delay = self._hedge_delay_s(path) if hedge else None
            t0 = time.perf_counter()
            if delay is not None:
                status, raw, retry_after, trace_id = \
                    self._hedged_roundtrip(request, delay)
            else:
                status, raw, retry_after, trace_id = \
                    self._roundtrip_once(request)
            attempts += 1
            if status in ok:
                self._record_latency(path, time.perf_counter() - t0)
                resp = Response(json.loads(raw or b"{}"))
                resp.attempts = attempts
                resp.trace_id = trace_id
                return resp
            err = make_error(status, raw, retry_after, trace_id,
                             f"{method} {path}")
            if self._should_retry(err) and attempts <= retries:
                # retryable errors are REJECTIONS (no server-side work
                # happened): resending cannot double-execute the POST
                time.sleep(self._backoff_delay(attempts, retry_after))
                continue
            raise err

    def health(self) -> Dict[str, Any]:
        return self._request("GET", "/health", retries=0)

    def healthz(self) -> Dict[str, Any]:
        """Readiness probe — raises HTTPStatusError("... 503 ...") until
        the endpoint has >=1 loaded model and a live coalescer.  Never
        retried: this route exists to observe the 503."""
        return self._request("GET", "/healthz", retries=0)

    def metrics(self, format: str = "json"):
        """Endpoint metrics: ``format="json"`` returns the structured
        dict, ``format="prometheus"`` the text exposition (a str)."""
        if format == "json":
            return self._request("GET", "/metrics")
        status, raw, retry_after, trace_id = self._roundtrip_once(
            self._raw_request("GET", f"/metrics?format={format}"))
        if status != 200:
            raise make_error(status, raw, retry_after, trace_id,
                             f"GET /metrics?format={format}")
        return raw.decode("utf-8")

    def trace(self, trace_id: str) -> Dict[str, Any]:
        """Fetch the flight recorder's timeline for one request (by the
        ``trace_id`` echoed on responses as ``X-Request-Id`` / carried in
        stream events).  404 -> HTTPStatusError (evicted or unknown)."""
        return self._request(
            "GET", f"/v1/trace/{urllib.parse.quote(trace_id, safe='')}",
            retries=0)

    def traces(self, **filters: Any) -> Dict[str, Any]:
        """Flight recorder index: in-flight + recently completed traces.
        Keyword filters pass through as query parameters — ``status=504``,
        ``client="tenant-a"``, ``min_duration_ms=250``, ``limit=50``."""
        qs = urllib.parse.urlencode(
            {k: v for k, v in filters.items() if v is not None})
        return self._request("GET", f"/v1/traces{'?' + qs if qs else ''}",
                             retries=0)

    def usage(self, client: Optional[str] = None,
              version: Optional[str] = None) -> Dict[str, Any]:
        """Per-client / per-version cost attribution (GET /v1/usage),
        optionally narrowed to one client tag and/or version label."""
        qs = urllib.parse.urlencode(
            {k: v for k, v in (("client", client), ("version", version))
             if v is not None})
        return self._request("GET", f"/v1/usage{'?' + qs if qs else ''}",
                             retries=0)

    def slo(self, window_s: Optional[float] = None) -> Dict[str, Any]:
        """SLO autopilot status: policies with their latest evaluation,
        the decision audit log, and an SLI snapshot (GET /v1/slo)."""
        qs = f"?window_s={window_s}" if window_s is not None else ""
        return self._request("GET", f"/v1/slo{qs}", retries=0)

    def start_profile(self, duration_ms: int = 1000,
                      mode: str = "auto") -> Dict[str, Any]:
        """Kick off a time-boxed device-profile capture (202 Accepted);
        409 while one is already running, 503 when profiling is off."""
        return self._request("POST", "/v1/debug/profile",
                             {"duration_ms": duration_ms, "mode": mode},
                             retries=0, ok=(200, 202))

    def profile_status(self) -> Dict[str, Any]:
        return self._request("GET", "/v1/debug/profile", retries=0)

    def models(self) -> Dict[str, Any]:
        return self._request("GET", "/v1/models")

    def _model_path(self, name: str, action: str = "") -> str:
        # member names may contain '#' (fragment delimiter): encode them
        return (f"/v1/models/{urllib.parse.quote(name, safe='')}"
                f"{'/' + action if action else ''}")

    def model_status(self, name: str) -> Dict[str, Any]:
        return self._request("GET", self._model_path(name))

    def load_model(self, name: str, version: Optional[int] = None,
                   alias: Optional[str] = None,
                   warm: bool = True) -> Dict[str, Any]:
        body: Dict[str, Any] = {"warm": warm}
        if version is not None:
            body["version"] = version
        if alias is not None:
            body["alias"] = alias
        return self._request("POST", self._model_path(name, "load"), body)

    def unload_model(self, name: str,
                     version: Optional[int] = None) -> Dict[str, Any]:
        body = {} if version is None else {"version": version}
        return self._request("POST", self._model_path(name, "unload"), body)

    def rollback_model(self, name: str,
                       alias: Optional[str] = None) -> Dict[str, Any]:
        body = {} if alias is None else {"alias": alias}
        return self._request("POST", self._model_path(name, "rollback"), body)

    def gc_model(self, name: str, keep_last_n: int) -> Dict[str, Any]:
        """Retention GC: delete store versions beyond the newest
        ``keep_last_n`` (versions referenced by a serving alias survive)."""
        return self._request("POST", self._model_path(name, "gc"),
                             {"keep_last_n": keep_last_n})

    # --- generation-engine lifecycle ------------------------------------------

    def _engine_path(self, name: str, action: str) -> str:
        return (f"/v1/engines/{urllib.parse.quote(name, safe='')}/{action}")

    def engines(self) -> Dict[str, Any]:
        return self._request("GET", "/v1/engines")

    def load_engine(self, name: str, version: Optional[int] = None,
                    alias: Optional[str] = None) -> Dict[str, Any]:
        body: Dict[str, Any] = {}
        if version is not None:
            body["version"] = version
        if alias is not None:
            body["alias"] = alias
        return self._request("POST", self._engine_path(name, "load"), body)

    def rollback_engine(self, name: str,
                        alias: Optional[str] = None) -> Dict[str, Any]:
        body = {} if alias is None else {"alias": alias}
        return self._request("POST", self._engine_path(name, "rollback"),
                             body)

    # --- replica admin --------------------------------------------------------

    def replicas(self) -> Dict[str, Any]:
        """Per-replica lifecycle states + pool counters
        (GET /v1/replicas); works in single-service mode too."""
        return self._request("GET", "/v1/replicas", retries=0)

    def cordon_replica(self, rid: int,
                       reason: Optional[str] = None) -> Dict[str, Any]:
        """Drain-aware operator cordon: the replica takes no new work but
        finishes what it has.  409 without a replica pool."""
        body = {} if reason is None else {"reason": reason}
        return self._request("POST", f"/v1/replicas/{rid}/cordon", body,
                             retries=0)

    def uncordon_replica(self, rid: int) -> Dict[str, Any]:
        return self._request("POST", f"/v1/replicas/{rid}/uncordon", {},
                             retries=0)

    def hedge_stats(self) -> Dict[str, Any]:
        """Client-side hedging counters (all zero when hedging is off)."""
        return {"enabled": self.hedge_ms is not None,
                "hedges": self.hedges, "hedge_wins": self.hedge_wins}

    @staticmethod
    def _plane_fields(body: Dict[str, Any], priority, deadline_ms,
                      client_tag, trace_id) -> Dict[str, Any]:
        for key, val in (("priority", priority),
                         ("deadline_ms", deadline_ms),
                         ("client", client_tag), ("trace_id", trace_id)):
            if val is not None:
                body[key] = val
        return body

    def infer(self, inputs: Dict[str, Any], policy: str = "soft_vote",
              target: Optional[str] = None, *,
              priority: Optional[str] = None,
              deadline_ms: Optional[float] = None,
              client_tag: Optional[str] = None,
              trace_id: Optional[str] = None) -> Dict[str, Any]:
        body: Dict[str, Any] = {"inputs": inputs, "policy": policy}
        if target is not None:
            body["target"] = target
        self._plane_fields(body, priority, deadline_ms, client_tag,
                           trace_id)
        return self._request("POST", "/v1/infer", body, hedge=True)

    def detect(self, inputs: Dict[str, Any], positive_class: int,
               policy: str = "or", threshold: float = 0.5,
               target: Optional[str] = None, *,
               priority: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               client_tag: Optional[str] = None,
               trace_id: Optional[str] = None) -> Dict[str, Any]:
        body: Dict[str, Any] = {"inputs": inputs,
                                "positive_class": positive_class,
                                "policy": policy, "threshold": threshold}
        if target is not None:
            body["target"] = target
        self._plane_fields(body, priority, deadline_ms, client_tag,
                           trace_id)
        return self._request("POST", "/v1/detect", body, hedge=True)

    @staticmethod
    def _generate_body(prompts, max_new_tokens, eos_id, *,
                       temperature=None, top_k=None, top_p=None, seed=None,
                       stop=None, speculation=None, target=None,
                       priority=None, deadline_ms=None, client_tag=None,
                       trace_id=None) -> Dict[str, Any]:
        body: Dict[str, Any] = {"prompts": [list(p) for p in prompts],
                                "max_new_tokens": max_new_tokens,
                                "eos_id": eos_id}
        for key, val in (("temperature", temperature), ("top_k", top_k),
                         ("top_p", top_p), ("seed", seed), ("stop", stop),
                         ("speculation", speculation),
                         ("target", target), ("priority", priority),
                         ("deadline_ms", deadline_ms),
                         ("client", client_tag), ("trace_id", trace_id)):
            if val is not None:
                body[key] = val
        return body

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 **sampling: Any) -> Dict[str, Any]:
        """Blocking generate; ``sampling`` may carry temperature / top_k /
        top_p / seed / stop / speculation (False opts this request out of
        speculative decoding) / target (an engine version alias)."""
        return self._request(
            "POST", "/v1/generate",
            self._generate_body(prompts, max_new_tokens, eos_id, **sampling))

    def generate_stream(self, prompt: Sequence[int],
                        max_new_tokens: int = 16,
                        eos_id: Optional[int] = None,
                        **sampling: Any) -> Iterator[Dict[str, Any]]:
        """Streamed generate for ONE prompt: yields event dicts (see
        ``serving/api.py``) as the server decodes.  Consume to the terminal
        event — on a speculative engine its ``"speculation"`` summary
        carries proposed/accepted/acceptance_rate — or ``close()`` the
        client to abandon mid-stream (the server cancels the request and
        frees its slot)."""
        body = self._generate_body([prompt], max_new_tokens, eos_id,
                                   **sampling)
        body["stream"] = True
        request = self._raw_request("POST", "/v1/generate", body)
        # eager send: the request is in flight (and errors surface) before
        # the caller pulls the first event; a stale reused keep-alive
        # connection is re-opened once, exactly like _request.  A 429/503
        # rejection (head known before any event) is retried with the
        # same backoff policy as unary requests.
        attempts = 0
        while True:
            for attempt in (0, 1):
                fresh = getattr(self._local, "conn", None) is None
                try:
                    status, records, retry_after = \
                        self._conn().stream(request)
                    break
                except socket.timeout:
                    self.close()
                    raise
                except (ConnectionError, OSError):
                    self.close()
                    if attempt or fresh:
                        raise
            attempts += 1
            if status != 200:
                # drain the error body (keeps the connection reusable)
                # and classify it through the taxonomy
                err = make_error(status, b"".join(records), retry_after,
                                 None, "POST /v1/generate")
                if self._should_retry(err) and attempts <= self.retries:
                    time.sleep(self._backoff_delay(attempts, retry_after))
                    continue
                raise err
            return (json.loads(record) for record in records)
