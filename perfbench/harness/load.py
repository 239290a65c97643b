"""The benchmark's own HTTP clients (standard library only): they drive a
window of a mix against the server and time every request from when it
was due to the last byte of its response.

In the closed loop a request is due when its client is ready to send it
(its body made, its last reply read).  In the open loop it is due at its
place in the schedule, whether or not a connection is free to send it:
a stall that holds up later requests shows in their latency, and how late
the sender ran is kept beside it (``lateness_s``)."""

from __future__ import annotations

import copy
import http.client
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from perfbench.harness.traffic import Mix, Request


@dataclass
class Result:
    """One request's outcome (times on ``time.perf_counter``)."""

    request: Request
    tokens: np.ndarray
    due: float
    sent: float = 0.0
    done: Optional[float] = None      # None: never answered
    status: Optional[int] = None      # None: no HTTP status
    body: Optional[bytes] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == 200

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done is None else self.done - self.due

    @property
    def lateness_s(self) -> float:
        return self.sent - self.due


class Client:
    """One keep-alive connection."""

    def __init__(self, host: str, port: int, timeout: float):
        self.host, self.port, self.timeout = host, port, timeout
        self.conn: Optional[http.client.HTTPConnection] = None

    def post(self, path: str, body: bytes):
        """(status, response bytes); reconnects once on a dropped
        keep-alive connection."""
        for attempt in (0, 1):
            if self.conn is None:
                self.conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout)
            try:
                self.conn.request("POST", path, body,
                                  {"Content-Type": "application/json"})
                resp = self.conn.getresponse()
                return resp.status, resp.read()
            except (ConnectionError, http.client.HTTPException):
                self.close()
                if attempt:
                    raise

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def _send(client: Client, path: str, res: Result, body: bytes) -> None:
    res.sent = time.perf_counter()
    try:
        status, answer = client.post(path, body)
        # ``done`` first: a result read while this thread runs is answered
        # only once it has its time
        res.done = time.perf_counter()
        res.status, res.body = status, answer
    except (OSError, http.client.HTTPException) as e:
        res.error = f"{type(e).__name__}: {e}"
        client.close()


def run_window(mix: Mix, host: str, port: int, path: str,
               encode: Callable[[np.ndarray], bytes], t_start: float,
               seconds: float, grace_s: float = 60.0,
               during: Optional[Callable[[], None]] = None) -> List[Result]:
    """Drive the window that opens at ``t_start`` (perf_counter) and lasts
    ``seconds``; requests already sent are waited for up to ``grace_s``
    past the close.  ``during`` runs on the calling thread while the
    clients send (the profiler's sub-window).  Returns every request
    sent, in order of due time."""
    t_end = t_start + seconds
    timeout = seconds + grace_s
    results: List[Result] = []
    lock = threading.Lock()

    if mix.loop == "closed":
        def closed_client(c: int) -> None:
            client = Client(host, port, timeout)
            k = 0
            try:
                while True:
                    req = mix.closed_request(c, k)
                    tokens = mix.tokens(req)
                    body = encode(tokens)
                    now = time.perf_counter()
                    if k == 0 and now < t_start:
                        time.sleep(t_start - now)
                        now = t_start
                    if now >= t_end:
                        return
                    res = Result(req, tokens, due=now)
                    with lock:
                        results.append(res)
                    _send(client, path, res, body)
                    k += 1
            finally:
                client.close()

        threads = [threading.Thread(target=closed_client, args=(c,),
                                    daemon=True, name=f"bench-client-{c}")
                   for c in range(mix.clients)]
    else:
        schedule = mix.schedule(seconds)
        todo: "queue.Queue[Optional[tuple]]" = queue.Queue()
        prepared = [(req, mix.tokens(req)) for req in schedule]
        prepared = [(req, tok, encode(tok)) for req, tok in prepared]

        def sender() -> None:
            client = Client(host, port, timeout)
            try:
                while True:
                    item = todo.get()
                    if item is None:
                        return
                    res, body = item
                    _send(client, path, res, body)
            finally:
                client.close()

        def dispatcher() -> None:
            for req, tok, body in prepared:
                due = t_start + req.due_s
                now = time.perf_counter()
                if due > now:
                    time.sleep(due - now)
                res = Result(req, tok, due=due)
                with lock:
                    results.append(res)
                todo.put((res, body))
            for _ in range(mix.clients):
                todo.put(None)

        threads = [threading.Thread(target=sender, daemon=True,
                                    name=f"bench-sender-{i}")
                   for i in range(mix.clients)]
        threads.append(threading.Thread(target=dispatcher, daemon=True,
                                        name="bench-dispatcher"))
    for t in threads:
        t.start()
    if during is not None:
        during()
    for t in threads:
        t.join(max(0.0, t_end + grace_s - time.perf_counter()))
    # copies: a request still in flight past the grace stays unanswered
    # in what the run reads, whatever its thread writes later
    with lock:
        return sorted((copy.copy(r) for r in results),
                      key=lambda r: (r.due, r.request.client))
