"""The port's generate plane over HTTP against the JAX package's, on the CPU.

The JAX server and the port's server each hold an engine over the same
weights (the shared conftest's JAX smoke params, carried over with
``params.from_jax``), on a dense engine and on a paged one, and get the
same requests.  Blocking ``/v1/generate`` bodies, streamed token events,
the done event's keys and the error taxonomy must be equal.  Then the
contracts of tests/test_generate.py on the port: the first token before
done, the chunked NDJSON wire format, cancellation on disconnect,
backpressure (pause and replay), and ``install`` draining in-flight
streams.
"""

import json
import socket
import time

import pytest
import torch

from conftest import smoke_model
from repro.core import InferenceEngine as JEngine
from repro.core import ModelRegistry as JRegistry
from repro.core import PagedInferenceEngine as JPaged
from repro.serving import FlexServeApp as JApp
from repro.serving import FlexServeClient as JClient
from repro.serving import FlexServeServer as JServer
from repro.serving.client import HTTPStatusError as JHTTPStatusError
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (InferenceEngine, ModelRegistry,
                              PagedInferenceEngine, SamplingParams)
from repro_torch.models import build_model
from repro_torch.params import from_jax
from repro_torch.serving import (FlexServeApp, FlexServeClient,
                                 FlexServeServer, GenerationService,
                                 HTTPStatusError)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers every
    worker's torch would start a thread per core (several times the run's
    CPU time for the same results)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAX_LEN = 128
SLOTS = 4


def _engines(kind):
    _, jmodel, jp = smoke_model("yi-9b")
    tmodel = build_model(reduce_for_smoke(get_config("yi-9b")))
    tp = from_jax(_flatten(jp), "cpu")
    kw = dict(max_len=MAX_LEN, max_batch=SLOTS)
    if kind == "paged":
        return (JPaged(jmodel, jp, page_size=16, **kw),
                PagedInferenceEngine(tmodel, tp, page_size=16, **kw))
    return JEngine(jmodel, jp, **kw), InferenceEngine(tmodel, tp, **kw)


class Pair:
    """A JAX server and the port's server over the same weights."""

    def __init__(self, kind):
        jeng, teng = _engines(kind)
        self.tengine = teng
        self.japp = JApp(JRegistry(), None, jeng, num_slots=SLOTS,
                         trace=False)
        self.tapp = FlexServeApp(ModelRegistry(), None, teng,
                                 num_slots=SLOTS)
        self.servers = [JServer(self.japp).start(),
                        FlexServeServer(self.tapp).start()]
        self.jc = JClient(*self.servers[0].address)
        self.tc = FlexServeClient(*self.servers[1].address)

    def close(self):
        self.jc.close()
        self.tc.close()
        for s in self.servers:
            s.stop()


@pytest.fixture(scope="module", params=["dense", "paged"])
def pair(request):
    p = Pair(request.param)
    yield p
    p.close()


@pytest.fixture(scope="module")
def dense():
    p = Pair("dense")
    yield p
    p.close()


REQUESTS = {
    "greedy": dict(max_new_tokens=6),
    "seeded": dict(max_new_tokens=9, temperature=0.8, top_k=50, top_p=0.9,
                   seed=42),
    "plain": dict(max_new_tokens=5, temperature=1.0, seed=7),
}
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [400, 3, 77, 18, 250, 6, 11]]


def _idle(app, timeout=10.0):
    """Wait until the app's decode pool holds no request (a finished
    stream's slot is freed by the driver after its terminal event)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        g = app.generation.stats()
        if g["active_slots"] == 0 and g["pending"] == 0:
            return
        time.sleep(0.01)
    raise AssertionError("decode pool never went idle")


@pytest.mark.parametrize("workload", list(REQUESTS))
def test_blocking_bodies_equal_the_jax_server(pair, workload):
    want = pair.jc.generate(PROMPTS, **REQUESTS[workload])
    got = pair.tc.generate(PROMPTS, **REQUESTS[workload])
    assert set(got) == set(want) == {"outputs", "steps", "prompt_lengths",
                                     "finish_reasons"}
    assert got == want
    assert got["finish_reasons"] == ["length"] * len(PROMPTS)


@pytest.mark.parametrize("workload", list(REQUESTS))
def test_stream_events_equal_the_jax_server(pair, workload):
    streams = []
    for c, app in ((pair.jc, pair.japp), (pair.tc, pair.tapp)):
        streams.append(list(c.generate_stream(PROMPTS[2],
                                              **REQUESTS[workload])))
        _idle(app)
    want, got = streams
    toks = [[(e["token"], e["index"]) for e in s if e["event"] == "token"]
            for s in streams]
    assert toks[1] == toks[0]
    assert len(toks[1]) == REQUESTS[workload]["max_new_tokens"]
    assert got[-1]["event"] == want[-1]["event"] == "done"
    assert set(got[-1]) == set(want[-1])
    for key in ("tokens", "finish_reason", "token_count", "prompt_length",
                "engine", "sampling", "speculation"):
        assert got[-1][key] == want[-1][key], key
    assert [e["token"] for e in got[:-1]] == got[-1]["tokens"]


def test_seeded_stream_equals_its_blocking_body(dense):
    kw = REQUESTS["seeded"]
    body = dense.tc.generate([PROMPTS[0]], **kw)["outputs"][0]
    events = list(dense.tc.generate_stream(PROMPTS[0], **kw))
    assert [e["token"] for e in events if e["event"] == "token"] == body


def test_stream_first_token_before_done(dense):
    t_first = t_done = None
    events = []
    for ev in dense.tc.generate_stream([1, 2, 3], max_new_tokens=16):
        events.append(ev)
        if ev["event"] == "token" and t_first is None:
            t_first = time.perf_counter()
        if ev["event"] == "done":
            t_done = time.perf_counter()
    assert t_first is not None and t_done is not None and t_first < t_done
    done = events[-1]
    assert done["ttft_ms"] < done["total_ms"]
    assert done["finish_reason"] == "length"
    assert done["token_count"] == 16 and done["engine"] == "engine@v0"


def _read_line(f):
    line = f.readline(65537)
    assert line.endswith(b"\r\n"), line
    return line[:-2]


def test_stream_chunked_wire_format(dense):
    """Raw bytes: a chunked application/x-ndjson body, one event per
    chunk, a zero-size terminator; the keep-alive connection then serves
    the next request."""
    body = json.dumps({"prompts": [[2, 4, 6]], "max_new_tokens": 5,
                       "stream": True}).encode()
    sock = socket.create_connection(dense.servers[1].address, timeout=30)
    f = sock.makefile("rb")
    try:
        sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        assert _read_line(f) == b"HTTP/1.1 200 OK"
        headers = {}
        while True:
            line = _read_line(f)
            if not line:
                break
            k, _, v = line.partition(b":")
            headers[k.strip().lower()] = v.strip()
        assert headers[b"content-type"] == b"application/x-ndjson"
        assert headers[b"transfer-encoding"] == b"chunked"
        assert b"content-length" not in headers
        events = []
        while True:
            size = int(_read_line(f), 16)
            if size == 0:
                assert _read_line(f) == b""
                break
            data = f.read(size)
            assert f.read(2) == b"\r\n"
            assert data.endswith(b"\n") and data.count(b"\n") == 1
            events.append(json.loads(data))
        tokens = [e for e in events if e["event"] == "token"]
        assert [e["index"] for e in tokens] == list(range(5))
        assert events[-1]["event"] == "done"
        assert [e["token"] for e in tokens] == events[-1]["tokens"]
        assert events[-1]["prompt_length"] == 3
        sock.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")
        assert _read_line(f) == b"HTTP/1.1 200 OK"
    finally:
        f.close()
        sock.close()
    assert dense.tc.health()["status"] == "ok"


def test_stream_disconnect_cancels_and_frees_slot(dense):
    host, port = dense.servers[1].address
    probe = FlexServeClient(host, port)
    before = probe.metrics()["generate"]["cancelled"]
    victim = FlexServeClient(host, port)
    stream = victim.generate_stream([1, 1, 2], max_new_tokens=100)
    for _ in range(2):
        assert next(stream)["event"] == "token"
    victim.close()
    deadline = time.time() + 10
    while time.time() < deadline:
        g = probe.metrics()["generate"]
        if g["cancelled"] > before and g["active_slots"] == 0:
            break
        time.sleep(0.05)
    g = probe.metrics()["generate"]
    assert g["cancelled"] > before, "disconnect never cancelled the request"
    assert g["active_slots"] == 0, "cancelled stream left its slot occupied"
    assert g["streams"]["cancelled"] >= 1
    probe.close()


def test_backpressure_pauses_and_replays(dense):
    """A consumer that does not read fills its one-event queue: the slot
    is paused (no buffering), and reading again replays the missed tokens
    in order and resumes the request to the same stream."""
    eng = dense.tengine
    gen = GenerationService(eng, num_slots=2, max_stream_buffer=1)
    try:
        samp = SamplingParams(max_new_tokens=12, temperature=0.8, seed=5)
        ref = gen.generate([[5, 6, 7]], samp).tokens[0]
        stream = gen.stream([5, 6, 7], samp)
        deadline = time.monotonic() + 10
        while not stream.request.paused and time.monotonic() < deadline:
            time.sleep(0.005)
        assert stream.request.paused, "full queue never paused the slot"
        events = list(stream.events(timeout=30))
        toks = [e for e in events if e["event"] == "token"]
        assert [e["index"] for e in toks] == list(range(12))
        assert any(e.get("replayed") for e in toks)
        assert [e["token"] for e in toks] == ref
        assert events[-1]["pauses"] >= 1
        assert gen.stats()["streams"]["paused"] >= 1
    finally:
        gen.close()


def test_install_drains_in_flight_streams(dense):
    eng = dense.tengine
    gen = GenerationService(eng, num_slots=2)
    try:
        stream = gen.stream([1, 2, 3], SamplingParams(max_new_tokens=40))
        it = stream.events()
        assert next(it)["event"] == "token"
        engine2 = InferenceEngine(eng.model, eng.params, max_len=MAX_LEN,
                                  max_batch=SLOTS)
        res = gen.install("engine", 1, engine2)
        assert res["drained"] and res["previous_engine"] == "engine@v0"
        done = list(it)[-1]
        assert done["event"] == "done"
        assert done["token_count"] == 40
        assert done["engine"] == "engine@v0"
        done2 = list(gen.stream([1, 2, 3],
                                SamplingParams(max_new_tokens=4)).events())[-1]
        assert done2["engine"] == "engine@v1"
        assert gen.entry_for().label == "engine@v1"
        assert gen.engine_for() is engine2
    finally:
        gen.close()


ERRORS = [
    {"prompts": [[1, 2]], "temperature": -0.5},
    {"prompts": [[1, 2]], "top_p": 1.5},
    {"prompts": [[1, 2]], "max_new_tokens": 0},
    {"prompts": [[1, 2]], "temperature": -0.5, "stream": True},
    {"prompts": [[1], [2]], "stream": True},
    {"prompts": []},
    {"prompts": "x"},
    {"prompts": [[1] * 200]},
    {"prompts": [[1]], "priority": "x"},
    {"prompts": [[1]], "target": "canary"},
]


def _error(client, body):
    with pytest.raises((HTTPStatusError, JHTTPStatusError)) as e:
        client._request("POST", "/v1/generate", body, retries=0)
    return e.value


@pytest.mark.parametrize("body", ERRORS)
def test_errors_match_the_jax_server(dense, body):
    want, got = (_error(c, body) for c in (dense.jc, dense.tc))
    assert (got.status, got.code, got.retryable) == \
        (want.status, want.code, want.retryable)
    assert got.status in (400, 404)


@pytest.mark.parametrize("stream", [False, True])
def test_busy_plane_sheds_429_with_retry_after(dense, stream):
    """The plane is budgeted in tokens: with another request holding all
    but a few units, a request costing more is shed with a retryable 429
    and a Retry-After hint, on both servers."""
    got = []
    for app, c in ((dense.japp, dense.jc), (dense.tapp, dense.tc)):
        ctx = app.admission.context({}, None)
        ticket = app.admission.admit("generate", ctx,
                                     app.generate_token_budget - 4)
        try:
            err = _error(c, {"prompts": [[1, 2, 3]], "max_new_tokens": 8,
                             "stream": stream})
        finally:
            ticket.release()
        got.append((err.status, err.code, err.retryable,
                    err.retry_after_s is not None))
    assert got[1] == got[0] == (429, "queue_full", True, True)


def test_generate_metrics_keys_equal_the_jax_server(pair):
    want, got = pair.jc.metrics(), pair.tc.metrics()
    for section in ("generate", "replicas", "faults"):
        assert set(got[section]) == set(want[section]), section
    assert set(got["generate"]["decode"]) == set(want["generate"]["decode"])
    assert set(got["generate"]["streams"]) == set(want["generate"]["streams"])
    d = got["generate"]["decode"]
    assert d["transfer_bytes_total"] == SLOTS * 4 * d["ticks"] > 0
    assert got["faults"] == want["faults"]
