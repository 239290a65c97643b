"""The port's telemetry plane, on the CPU: the contracts of
``tests/test_telemetry.py`` (histogram/reservoir units, the flight
recorder, /metrics schema stability in JSON and Prometheus exposition, the
/v1/trace/{id} surface across admitted / shed / deadline outcomes, the
profiler's python mode) plus its torch mode, and the port held against
the JAX package: ``prometheus_exposition`` byte for byte on the same stats
documents, the span and event names of the same infer and generate
requests, and the key schema of /metrics' telemetry, slo, usage and
lifecycle sections."""

import json
import os
import time

import jax
import pytest
import torch

from conftest import smoke_model
from repro.core import Ensemble as JEnsemble
from repro.core import EnsembleMember as JMember
from repro.core import InferenceEngine as JEngine
from repro.core import ModelRegistry as JRegistry
from repro.serving import FlexServeApp as JApp
from repro.serving import FlexServeServer as JServer
from repro.serving.telemetry import \
    prometheus_exposition as jprometheus_exposition
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (Ensemble, EnsembleMember, InferenceEngine,
                              ModelRegistry)
from repro_torch.core.telemetry import Histogram, Reservoir
from repro_torch.models.build import build_model
from repro_torch.params import from_jax
from repro_torch.serving import (FlexServeApp, FlexServeClient,
                                 FlexServeServer, FlightRecorder,
                                 HTTPStatusError, prometheus_exposition)
from repro_torch.serving import telemetry


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


# every histogram snapshot key the /metrics schema documents
HIST_KEYS = {"le", "counts", "count", "sum"}

# documented top-level /metrics sections (api.py docstring): the schema-
# stability contract — present at boot, present under traffic
SECTIONS = ("uptime_s", "requests", "routes", "coalesce", "lifecycle",
            "generate", "admission", "usage", "slo", "telemetry")


def _build_app(tmpdir=None, **kw):
    model = build_model(reduce_for_smoke(get_config("yi-9b")))
    registry = ModelRegistry()
    members = []
    for i in range(2):
        pp = model.init(i, "cpu")
        registry.register(f"yi#{i}", model, pp)

        def apply(p, batch, _m=model):
            return _m.forward(p, batch)[:, -1, :8]

        members.append(EnsembleMember(f"yi#{i}", apply, pp, 8))
    ensemble = Ensemble(members, max_batch=8)
    engine = InferenceEngine(model, members[0].params, max_len=64,
                             max_batch=4)
    return FlexServeApp(registry, ensemble, engine,
                        profile_dir=tmpdir, **kw)


@pytest.fixture(scope="module")
def profile_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("profiles"))


@pytest.fixture(scope="module")
def server(profile_dir):
    srv = FlexServeServer(_build_app(profile_dir)).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def client(server):
    host, port = server.address
    cl = FlexServeClient(host, port, retries=0)
    yield cl
    cl.close()


# --- unit: metric primitives -----------------------------------------------


def test_histogram_cumulative_and_exemplar():
    h = Histogram()
    for v in (0.3, 3.0, 30.0, 300.0):
        h.observe(v, trace_id=f"t-{v}")
    snap = h.snapshot()
    assert HIST_KEYS.issubset(snap)
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(333.3)
    assert snap["le"][-1] == "+Inf"
    assert len(snap["le"]) == len(snap["counts"])
    # cumulative: monotone nondecreasing, last == count
    assert all(a <= b for a, b in zip(snap["counts"], snap["counts"][1:]))
    assert snap["counts"][-1] == snap["count"]
    # exemplar tracks the largest observation
    assert snap["exemplar"]["trace_id"] == "t-300.0"
    assert 0.3 <= h.percentile(0.5) <= 30.0


def test_reservoir_bounded_and_percentiles():
    r = Reservoir(size=64, seed=1)
    for i in range(10_000):
        r.add(float(i))
    assert len(r) == 64
    p50, p95 = r.percentiles(0.50, 0.95)
    assert 2_000 < p50 < 8_000          # uniform sample, loose bounds
    assert p95 > p50
    assert Reservoir(size=8).percentile(0.5) == 0.0   # empty -> 0


def test_flight_recorder_ring_is_bounded():
    rec = FlightRecorder(capacity=4)
    for i in range(10):
        tr = rec.begin(f"t-{i}", "infer")
        tr.finish(status=200)
    st = rec.stats()
    assert st["completed"] == 4 and st["completed_total"] == 10
    assert st["in_flight"] == 0
    assert rec.get("t-3") is None        # evicted
    assert rec.get("t-9") is not None
    line = json.loads(rec.get("t-9").log_line())
    assert line["trace_id"] == "t-9" and line["status"] == 200


def test_prometheus_walker_skips_strings_and_renders_hists():
    h = Histogram()
    h.observe(5.0)
    text = prometheus_exposition(
        {"requests": 3, "note": "a string", "nested": {"ok": True},
         "lat": h.snapshot()})
    assert "flexserve_requests 3" in text
    assert "note" not in text
    assert "flexserve_nested_ok 1" in text
    assert 'flexserve_lat_bucket{le="+Inf"} 1' in text
    assert "flexserve_lat_count 1" in text


# --- /metrics schema: zero at boot, populated after traffic ----------------


def test_metrics_schema_zero_at_boot():
    app = _build_app()
    try:
        m = app.handle("GET", "/metrics", b"")
        for key in SECTIONS:
            assert key in m, f"missing /metrics section {key!r}"
        assert m["requests"] == 1                  # this very request
        # no manager: lifecycle is present but zeroed
        assert m["lifecycle"]["loads"] == 0
        gen = m["generate"]
        for hk in ("request_latency_ms_hist", "ttft_ms_hist",
                   "inter_token_ms_hist", "queue_wait_ms_hist"):
            assert gen[hk]["count"] == 0, hk
        for hk in ("host_ms_hist", "device_ms_hist", "prefill_ms_hist",
                   "transfer_bytes_hist"):
            assert gen["decode"][hk]["count"] == 0, hk
        # dense engine: pager section present and zeroed (schema stable
        # across dense/paged deployments)
        assert gen["pager"]["pages_total"] == 0
        assert gen["pager"]["oom_events"] == 0
        t = m["telemetry"]
        assert t["completed_total"] == 0 and t["in_flight"] == 0
        # PR 8: usage + slo sections are schema-stable too — present and
        # zeroed even with no SLO policies configured
        u = m["usage"]
        for uk in ("requests", "errors", "prefill_tokens", "decode_tokens",
                   "device_ms", "decode_host_ms"):
            assert u[uk] == 0, uk
        assert u["clients"] == 0 and u["versions"] == 0
        s = m["slo"]
        assert s["policies"] == 0
        assert s["promotions"] == 0 and s["rollbacks"] == 0
        assert s["breaches"] == 0 and s["evaluations"] == 0
        assert m["uptime_s"] >= 0.0
    finally:
        app.close()


def test_metrics_populated_after_traffic(client):
    client.generate([[1, 2, 3]], max_new_tokens=4)
    client.infer({"tokens": [[1, 2, 3, 4]]})
    m = client.metrics()
    gen = m["generate"]
    assert gen["request_latency_ms_hist"]["count"] >= 1
    assert gen["ttft_ms_hist"]["count"] >= 1
    assert gen["queue_wait_ms_hist"]["count"] >= 1
    assert gen["decode"]["prefill_ms_hist"]["count"] >= 1
    assert m["coalesce"]["queue_wait_ms_hist"]["count"] >= 1
    assert m["telemetry"]["completed_total"] >= 2
    admitted = m["admission"]["planes"]["generate"]["admitted"]
    assert sum(admitted.values()) >= 1


# --- Prometheus exposition round-trip --------------------------------------


def _parse_prometheus(text):
    """-> (samples {name: [(labels, value)]}, types {name: type})."""
    samples, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            types[name] = typ
            continue
        if not line or line.startswith("#"):
            continue
        metric, _, value = line.rpartition(" ")
        name, labels = metric, ""
        if "{" in metric:
            name, _, labels = metric.partition("{")
            labels = labels.rstrip("}")
        samples.setdefault(name, []).append((labels, float(value)))
    return samples, types


def test_prometheus_exposition_roundtrip(client):
    client.generate([[4, 5, 6]], max_new_tokens=4)
    text = client.metrics(format="prometheus")
    assert isinstance(text, str)
    samples, types = _parse_prometheus(text)
    # every stats section is scrapeable
    for section in ("admission", "coalesce", "generate", "lifecycle",
                    "usage", "slo", "telemetry"):
        assert any(n.startswith(f"flexserve_{section}_")
                   for n in samples), f"no {section} samples"
    # PR 8 cost accounting reaches the scrape path
    assert samples["flexserve_usage_requests"][0][1] >= 1
    assert any(n.startswith("flexserve_generate_pager_") for n in samples)
    # histogram families: cumulative buckets, +Inf == count
    hist = "flexserve_generate_request_latency_ms_hist"
    assert types[hist] == "histogram"
    buckets = samples[f"{hist}_bucket"]
    counts = [v for _, v in buckets]
    assert all(a <= b for a, b in zip(counts, counts[1:]))
    assert buckets[-1][0] == 'le="+Inf"'
    assert counts[-1] == samples[f"{hist}_count"][0][1]
    assert samples[f"{hist}_count"][0][1] >= 1


def test_prometheus_unknown_format_is_400(client):
    with pytest.raises(HTTPStatusError, match="400"):
        client.metrics(format="protobuf")


# --- /v1/trace/{id}: admitted, shed, deadline ------------------------------


def test_trace_of_admitted_generate(client):
    resp = client.generate([[7, 8, 9]], max_new_tokens=4,
                           trace_id="tele-ok-1")
    assert resp.trace_id == "tele-ok-1"       # X-Request-Id echo
    snap = client.trace("tele-ok-1")
    assert snap["trace_id"] == "tele-ok-1"
    assert snap["status"] == 200 and not snap["in_flight"]
    names = {s["name"] for s in snap["spans"]}
    assert {"http_parse", "queue_wait", "prefill"}.issubset(names)
    events = {e["name"] for e in snap["events"]}
    assert {"admitted", "scheduler_queued", "first_token",
            "request_finished"}.issubset(events)
    # prefill yields the first token; the remaining 3 come from decode
    assert snap["counters"]["decode_ticks"] >= 3
    # timeline is ordered and fits inside the request duration
    for s in snap["spans"]:
        assert s["start_ms"] <= s["end_ms"]
        assert s["end_ms"] <= snap["duration_ms"] + 1e-6


def test_trace_of_shed_request(client, server):
    # generate plane budget is 32 * max_queue = 2048 tokens.  An empty
    # plane admits even an over-budget request, so hold a stream open on
    # a second connection to keep depth > 0, then push one over budget:
    # it sheds as 429 — and leaves a queryable timeline.
    holder = FlexServeClient(*server.address, retries=0)
    try:
        events = holder.generate_stream([1, 2, 3], max_new_tokens=48)
        next(events)                       # stream admitted and decoding
        with pytest.raises(HTTPStatusError) as ei:
            client.generate([[1, 2, 3]], max_new_tokens=4096,
                            trace_id="tele-shed-1")
        assert ei.value.status == 429
        for _ in events:                   # drain; frees the connection
            pass
    finally:
        holder.close()
    snap = client.trace("tele-shed-1")
    assert snap["status"] == 429 and not snap["in_flight"]
    shed = [e for e in snap["events"] if e["name"] == "shed"]
    assert shed and shed[0]["attrs"]["plane"] == "generate"


def test_trace_of_deadline_rejected_request(client):
    with pytest.raises(HTTPStatusError) as ei:
        client.generate([[1, 2, 3]], max_new_tokens=4,
                        deadline_ms=1e-6, trace_id="tele-dl-1")
    assert ei.value.status == 504
    snap = client.trace("tele-dl-1")
    assert snap["status"] == 504
    drops = [e for e in snap["events"] if e["name"] == "deadline_drop"]
    assert drops and drops[0]["attrs"]["stage"] == "admission"


def test_trace_of_stream_is_sealed_by_terminal_event(client):
    events = list(client.generate_stream([1, 2, 3], max_new_tokens=4,
                                         trace_id="tele-stream-1"))
    assert events[-1]["event"] == "done"
    snap = client.trace("tele-stream-1")
    assert snap["status"] == 200 and not snap["in_flight"]
    assert snap["counters"]["stream_events"] >= 4
    assert snap["finish_reason"] in ("length", "stop", "eos")


def test_trace_unknown_id_is_404(client):
    with pytest.raises(HTTPStatusError, match="404"):
        client.trace("never-issued")


def test_traces_index(client):
    idx = client.traces()
    assert idx["telemetry"]["completed_total"] >= 1
    assert isinstance(idx["recent"], list) and idx["recent"]
    assert {"trace_id", "plane", "status"}.issubset(idx["recent"][0])


# --- on-demand profiling ----------------------------------------------------


def test_profile_python_mode_writes_artifact(client, profile_dir):
    resp = client.start_profile(duration_ms=120, mode="python")
    assert resp["mode"] == "python"
    artifact = resp["artifact"]
    assert artifact.startswith(profile_dir)
    # a second capture while one is running is refused
    with pytest.raises(HTTPStatusError, match="409"):
        client.start_profile(duration_ms=120, mode="python")
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if client.profile_status()["active"] is None:
            break
        time.sleep(0.05)
    assert os.path.exists(artifact)
    with open(artifact) as fh:
        doc = json.load(fh)
    assert doc["mode"] == "python" and doc["samples"] >= 1
    assert client.profile_status()["captures_total"] >= 1


def test_profile_disabled_without_dir():
    app = _build_app()      # no profile_dir
    try:
        srv = FlexServeServer(app).start()
        cl = FlexServeClient(*srv.address, retries=0)
        with pytest.raises(HTTPStatusError, match="503"):
            cl.start_profile(duration_ms=50)
        cl.close()
        srv.stop()
    finally:
        app.close()


# --- clocks -----------------------------------------------------------------


def test_uptime_is_monotonic_based(client):
    m1 = client.metrics()
    m2 = client.metrics()
    assert 0.0 <= m1["uptime_s"] <= m2["uptime_s"]
    assert abs(m1["started_unix"] - time.time()) < 3600


# --- torch mode and failures -------------------------------------------------


def _wait_idle(cl, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = cl.profile_status()
        if st["active"] is None:
            return st
        time.sleep(0.05)
    pytest.fail("profile capture never finished")


def test_profile_torch_mode_writes_trace_and_kernel_table(client,
                                                          profile_dir):
    resp = client.start_profile(duration_ms=150, mode="torch")
    assert resp["mode"] == "torch"
    client.generate([[1, 2, 3]], max_new_tokens=3)
    st = _wait_idle(client)
    assert st["last"]["ok"] and st["last_error"] is None
    art = resp["artifact"]
    assert art.startswith(profile_dir)
    assert os.path.getsize(os.path.join(art, "trace.json")) > 0
    with open(os.path.join(art, "kernels.json")) as fh:
        doc = json.load(fh)
    # on the CPU there is no device activity and so no kernel row
    assert doc["mode"] == "torch" and doc["activities"] == ["CPU"]
    assert doc["device"] == "cpu" and doc["kernels"] == []
    # "auto" is torch; a JAX mode is refused
    assert client.start_profile(duration_ms=20)["mode"] == "torch"
    _wait_idle(client)
    with pytest.raises(HTTPStatusError, match="400"):
        client.start_profile(duration_ms=20, mode="jax")


def test_failed_capture_is_reported_not_retried(tmp_path, monkeypatch):
    prof = telemetry.DeviceProfiler(artifact_dir=str(tmp_path))

    def boom(info):
        raise RuntimeError("CUPTI unavailable")
    monkeypatch.setattr(prof, "_run_torch", boom)
    info = prof.start(duration_ms=10, mode="torch")
    deadline = time.monotonic() + 10
    while prof.status()["active"] is not None:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    st = prof.status()
    assert st["failures_total"] == 1 and st["captures_total"] == 1
    assert st["last_error"] == "RuntimeError: CUPTI unavailable"
    assert st["last"]["mode"] == "torch" and not st["last"]["ok"]
    assert not os.path.exists(info["artifact"])   # no python capture


# --- the port against the JAX package ----------------------------------------


def _stats_docs():
    h = Histogram()
    for v in (0.2, 7.0, 55.5, 1e4):
        h.observe(v, trace_id=f"t{v}")
    empty = Histogram().snapshot()
    return [
        {"requests": 3, "note": "x", "nested": {"ok": True, "no": False,
                                               "n": None, "l": [1]},
         "lat": h.snapshot(), "empty": empty},
        {"a-b": {"c.d": 1.5, "e f": float("inf"), "g": float("nan"),
                 "h": -2.0, "i": 1e20, "j": 0.1}, "_k_": {"": 1}},
    ]


@pytest.mark.parametrize("i", [0, 1])
def test_prometheus_exposition_equals_the_jax_package(i):
    doc = _stats_docs()[i]
    assert prometheus_exposition(doc) == jprometheus_exposition(doc)
    assert prometheus_exposition(doc, prefix="x") == \
        jprometheus_exposition(doc, prefix="x")


def test_prometheus_of_a_live_metrics_document_equals_the_jax_package(
        client):
    m = client.metrics()
    assert prometheus_exposition(m) == jprometheus_exposition(m)
    samples, _ = _parse_prometheus(client.metrics(format="prometheus"))

    def leaves(node, name):
        if isinstance(node, dict):
            if {"le", "counts", "count", "sum"} <= set(node):
                return {f"{name}_count"}
            return set().union(*[
                leaves(v, f"{name}_{telemetry._sanitize(k)}")
                for k, v in node.items()] or [set()])
        return {name} if isinstance(node, (int, float)) else set()
    # one sample per numeric JSON leaf, histograms as families
    want = leaves(m, "flexserve")
    assert len(want) > 100 and want <= set(samples)


@pytest.fixture(scope="module")
def twin_clients():
    """A JAX and a port app with the same weights, both traced."""
    cfg, jmodel, _ = smoke_model("yi-9b")
    tmodel = build_model(reduce_for_smoke(get_config("yi-9b")))
    jreg, treg, jm, tm = JRegistry(), ModelRegistry(), [], []
    for i in range(2):
        jp = jmodel.init(jax.random.PRNGKey(i))
        tp = from_jax(_flatten(jp), "cpu")
        jreg.register(f"yi#{i}", jmodel, jp)
        treg.register(f"yi#{i}", tmodel, tp)
        jm.append(JMember(f"yi#{i}", lambda p, b, _m=jmodel:
                          _m.forward(p, b)[:, -1, :8], jp, 8))
        tm.append(EnsembleMember(f"yi#{i}", lambda p, b, _m=tmodel:
                                 _m.forward(p, b)[:, -1, :8], tp, 8))
    japp = JApp(jreg, JEnsemble(jm, max_batch=8),
                JEngine(jmodel, jm[0].params, max_len=64, max_batch=4))
    tapp = FlexServeApp(treg, Ensemble(tm, max_batch=8),
                        InferenceEngine(tmodel, tm[0].params, max_len=64,
                                        max_batch=4))
    servers = [JServer(japp).start(), FlexServeServer(tapp).start()]
    cls = [FlexServeClient(*s.address, retries=0) for s in servers]
    yield cls
    for c in cls:
        c.close()
    for s in servers:
        s.stop()


def _names(snap):
    return (sorted(s["name"] for s in snap["spans"]),
            sorted(e["name"] for e in snap["events"]),
            sorted(snap["counters"]), sorted(snap.get("attrs", {})))


@pytest.mark.parametrize("plane", ["infer", "generate", "stream"])
def test_span_and_event_names_equal_the_jax_package(twin_clients, plane):
    got = []
    for c in twin_clients:
        tid = f"names-{plane}"
        if plane == "infer":
            c.infer({"tokens": [[1, 2, 3, 4]]}, trace_id=tid)
        elif plane == "generate":
            c.generate([[5, 6, 7]], max_new_tokens=4, trace_id=tid)
        else:
            list(c.generate_stream([5, 6, 7], max_new_tokens=4,
                                   trace_id=tid))
        got.append(_names(c.trace(tid)))
    assert got[1] == got[0]


def _keys(node):
    """The nested key schema of a JSON document (dict keys only)."""
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    return None


@pytest.mark.parametrize("section", ["telemetry", "slo", "usage",
                                     "lifecycle"])
def test_metrics_section_keys_equal_the_jax_package(twin_clients, section):
    for c in twin_clients:
        c.generate([[1, 2]], max_new_tokens=2, client_tag="gold")
    jm, tm = (c.metrics() for c in twin_clients)
    assert _keys(tm[section]) == _keys(jm[section])
