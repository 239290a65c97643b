"""The port's replica pool against tests/test_replica.py's contracts, on the
CPU: least-loaded routing, byte-identical failover (the fold_in rng
contract makes a resumed continuation emit exactly the tokens the failed
replica would have), the health monitor's kill and restart, a crash during
an engine swap, and the HTTP surface (/v1/replicas, cordon/uncordon,
/healthz aggregation, the /metrics replica and fault sections).  The
port's failed-over stream must also equal the JAX pool's under the same
fault schedule, on the same weights."""

import threading
import time

import pytest
import torch

from conftest import smoke_model
from repro.core import InferenceEngine as JEngine
from repro.core import ModelRegistry as JRegistry
from repro.core.faults import FaultInjector as JFaultInjector
from repro.core.sampling import SamplingParams as JSamplingParams
from repro.serving import FlexServeApp as JApp
from repro.serving import ReplicaPool as JReplicaPool
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (Ensemble, EnsembleMember, FaultInjector,
                              InferenceEngine, InjectedFault, ModelRegistry,
                              SamplingParams, SchedulerService)
from repro_torch.models import build_model
from repro_torch.params import from_jax
from repro_torch.serving import (FlexServeApp, FlexServeClient,
                                 FlexServeServer, GenerationService,
                                 NotFoundError, ReplicaPool, UnavailableError)
from repro_torch.serving import api


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


PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
KW = dict(max_len=128, max_batch=4)


def _samp(seed=11, n=16, cls=SamplingParams):
    return cls(temperature=0.8, seed=seed, max_new_tokens=n)


@pytest.fixture(scope="module")
def weights():
    _, jmodel, jp = smoke_model("yi-9b")
    tmodel = build_model(reduce_for_smoke(get_config("yi-9b")))
    return jmodel, jp, tmodel, from_jax(_flatten(jp), "cpu")


@pytest.fixture(scope="module")
def engine(weights):
    _, _, tmodel, tp = weights
    return InferenceEngine(tmodel, tp, **KW)


def _reference(engine, prompt, sampling):
    svc = SchedulerService(engine, 2)
    try:
        return svc.submit_and_wait([prompt], sampling=sampling).tokens[0]
    finally:
        svc.close()


def _stream_collect(pool, prompt, sampling, timeout=60.0):
    done = threading.Event()
    box = {}

    def sink(req, token, is_done):
        if is_done:
            box["req"] = req
            done.set()

    pool.submit_request(prompt, sampling=sampling, sink=sink)
    assert done.wait(timeout), "stream never finished"
    return box["req"]


def test_pool_unary_matches_single_service(engine):
    svc = SchedulerService(engine, 2)
    try:
        ref = svc.submit_and_wait(PROMPTS, sampling=_samp())
    finally:
        svc.close()
    pool = ReplicaPool(engine, 3, num_slots=2)
    try:
        got = pool.submit_and_wait(PROMPTS, sampling=_samp())
    finally:
        pool.close()
    assert got.tokens == ref.tokens
    assert got.finish_reasons == ref.finish_reasons


FAILOVER = [{"site": "engine_step", "at": 4, "count": 1}]


def test_stream_failover_is_byte_identical_and_equals_the_jax_pool(
        weights, engine):
    """An engine_step fault mid-stream kills the request on its replica;
    the pool resubmits elsewhere with resume_output + the ORIGINAL rng
    key: the output equals the unfaulted run and the JAX pool's
    failed-over stream under the same schedule."""
    prompt = [3, 1, 4, 1, 5]
    ref = _reference(engine, prompt, _samp(seed=23, n=20))
    pool = ReplicaPool(engine, 3, num_slots=2,
                       faults=FaultInjector.load(FAILOVER), monitor=False,
                       max_failovers=3)
    try:
        req = _stream_collect(pool, prompt, _samp(seed=23, n=20))
        assert req.finish_reason == "length"
        assert list(req.output) == ref
        assert pool.failovers_total >= 1
        assert pool.failovers_by_kind["stream"] >= 1
        ours = (list(req.output), pool.failovers_total,
                pool.faults.stats())
    finally:
        pool.close()
    jmodel, jp, _, _ = weights
    jpool = JReplicaPool(JEngine(jmodel, jp, **KW), 3, num_slots=2,
                         faults=JFaultInjector.load(FAILOVER),
                         monitor=False, max_failovers=3)
    try:
        jreq = _stream_collect(jpool, prompt,
                               _samp(seed=23, n=20, cls=JSamplingParams))
        theirs = (list(jreq.output), jpool.failovers_total,
                  jpool.faults.stats())
    finally:
        jpool.close()
    assert ours == theirs


def test_unary_failover_is_transparent(engine):
    prompt, sampling = [9, 8, 7], _samp(seed=5, n=12)
    ref = _reference(engine, prompt, sampling)
    faults = FaultInjector.load(
        [{"site": "engine_step", "at": 3, "count": 1}])
    pool = ReplicaPool(engine, 2, num_slots=2, faults=faults,
                       monitor=False, max_failovers=3)
    try:
        got = pool.submit_and_wait([prompt], sampling=sampling)
        assert got.tokens[0] == ref
        assert pool.failovers_by_kind["unary"] >= 1
    finally:
        pool.close()


def test_failover_exhaustion_surfaces_the_error(engine):
    faults = FaultInjector.load(
        [{"site": "engine_step", "at": 2, "count": 1,
          "message": "injected step fault"}])
    pool = ReplicaPool(engine, 2, num_slots=2, faults=faults,
                       monitor=False, max_failovers=0)
    try:
        with pytest.raises(InjectedFault, match="injected step fault"):
            pool.submit_and_wait([[1, 2, 3]], sampling=_samp(n=8))
        assert pool.summary()["failover_failures"] == 0
    finally:
        pool.close()


def test_monitor_kills_restarts_and_streams_survive(engine):
    """replica_kill fires on replica 1 while six seeded streams decode:
    its in-flight work evacuates onto siblings byte-identically, the dead
    member is cordoned and auto-restarted back to ready."""
    n_tok = 32
    seeds = [100 + i for i in range(6)]
    prompt = [2, 7, 1, 8]
    svc = SchedulerService(engine, 2)
    try:
        refs = {s: svc.submit_and_wait(
            [prompt], sampling=_samp(seed=s, n=n_tok)).tokens[0]
            for s in seeds}
    finally:
        svc.close()
    faults = FaultInjector.load(
        [{"site": "replica_kill", "replica": 1, "at": 2, "count": 1}])
    pool = ReplicaPool(engine, 3, num_slots=2, faults=faults,
                       health_interval_s=0.01, max_failovers=3)
    try:
        done = {s: threading.Event() for s in seeds}
        boxes = {}

        def sink_for(s):
            def sink(req, token, is_done):
                if is_done:
                    boxes[s] = req
                    done[s].set()
            return sink

        for s in seeds:
            pool.submit_request(prompt, sampling=_samp(seed=s, n=n_tok),
                                sink=sink_for(s))
        for s in seeds:
            assert done[s].wait(120), f"stream seed={s} never finished"
        for s in seeds:
            assert boxes[s].finish_reason == "length"
            assert list(boxes[s].output) == refs[s], f"seed={s} diverged"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            summ = pool.summary()
            if summ["restarts"] >= 1 and summ["ready"] == 3:
                break
            time.sleep(0.05)
        summ = pool.summary()
        assert summ["kills"] >= 1
        assert summ["restarts"] >= 1
        assert summ["ready"] == 3
        assert pool.evacuations_total >= 1
        assert pool.failovers_total >= 1
    finally:
        pool.close()


def test_crash_during_engine_swap_never_publishes(engine):
    faults = FaultInjector.load(
        [{"site": "engine_install", "replica": 1, "at": 2, "count": 1}])
    gen = GenerationService(num_replicas=2, num_slots=2, faults=faults,
                            replica_options={"monitor": False})
    try:
        gen.install("m", 1, engine)
        ok = gen.generate([[1, 2, 3]], SamplingParams(max_new_tokens=4))
        assert len(ok.tokens[0]) == 4
        with pytest.raises(InjectedFault):
            gen.install("m", 2, engine)
        assert gen.entry_for(None).version == 1
        ok = gen.generate([[1, 2, 3]], SamplingParams(max_new_tokens=4))
        assert len(ok.tokens[0]) == 4
        res = gen.install("m", 2, engine)
        assert res["engine"] == "m@v2"
        assert gen.entry_for(None).version == 2
        assert gen.pool_for() is gen.entry_for().service
    finally:
        gen.close()


# --- HTTP surface ------------------------------------------------------------


@pytest.fixture(scope="module")
def server(weights, engine):
    _, _, tmodel, tp = weights
    registry = ModelRegistry()
    members = []
    for i in range(2):
        registry.register(f"yi#{i}", tmodel, tp)
        members.append(EnsembleMember(
            f"yi#{i}", lambda p, b, _m=tmodel: _m.forward(p, b)[:, -1, :8],
            tp, 8))
    app = FlexServeApp(registry, Ensemble(members, max_batch=8), engine,
                       replicas=3,
                       replica_options={"health_interval_s": 0.05})
    srv = FlexServeServer(app).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def client(server):
    c = FlexServeClient(*server.address)
    yield c
    c.close()


def test_healthz_aggregates_replica_health(client):
    h = client.healthz()
    assert h["replicas"] == {"count": 3, "ready": 3, "cordoned": []}


def test_replicas_route_and_cordon_cycle(client):
    r = client.replicas()
    assert r["enabled"] and r["count"] == 3
    assert set(r["per_replica"]) == {"0", "1", "2"}
    assert all(v["state"] == "ready" for v in r["per_replica"].values())
    d = client.cordon_replica(2, reason="maintenance")
    assert d["state"] == "cordoned" and d["manual"]
    assert client.healthz()["replicas"]["cordoned"] == [2]
    assert client.replicas()["per_replica"]["2"][
        "cordoned_reason"] == "maintenance"
    d = client.uncordon_replica(2)
    assert d["state"] == "ready"
    assert client.healthz()["replicas"]["cordoned"] == []


@pytest.mark.parametrize("path", ["/v1/replicas/99/cordon",
                                  "/v1/replicas/x/uncordon"])
def test_cordon_unknown_replica_is_typed_404(client, path):
    with pytest.raises(NotFoundError) as ei:
        client._request("POST", path, {}, retries=0)
    err = ei.value
    assert err.structured and err.code == "not_found"
    assert not err.retryable


def test_healthz_503_when_no_ready_replicas(client):
    for rid in (0, 1, 2):
        client.cordon_replica(rid)
    try:
        with pytest.raises(UnavailableError) as ei:
            client.healthz()
        assert ei.value.structured and ei.value.retryable
        assert "no ready replicas" in str(ei.value)
    finally:
        for rid in (0, 1, 2):
            client.uncordon_replica(rid)
    assert client.healthz()["replicas"]["ready"] == 3


def test_cordon_without_pool_is_409(engine):
    app = FlexServeApp(engine=engine)
    try:
        with pytest.raises(api.ApiError) as ei:
            app._replica_admin("POST", "0/cordon", b"{}")
        assert ei.value.status == 409
        single = app.handle("GET", "/v1/replicas", b"")
        assert single["count"] == single["ready"] == 1
        assert not single["enabled"]
    finally:
        app.close()


def test_generate_and_stream_through_pool_agree(client, engine):
    kw = dict(max_new_tokens=6, temperature=0.7, seed=3)
    unary = client.generate([[1, 2, 3]], **kw)["outputs"][0]
    events = list(client.generate_stream([1, 2, 3], **kw))
    assert events[-1]["event"] == "done"
    toks = [e["token"] for e in events if "token" in e]
    assert toks == unary
    assert toks == _reference(engine, [1, 2, 3], SamplingParams(**kw))


def _jax_sections(weights, **kw):
    jmodel, jp, _, _ = weights
    app = JApp(JRegistry(), None, JEngine(jmodel, jp, **KW), trace=False,
               **kw)
    try:
        m = app.handle("GET", "/metrics", b"")
        return {k: m[k] for k in ("replicas", "faults", "generate")}
    finally:
        app.close()


FAULTS = [{"site": "socket_drop", "at": 1000}, {"site": "prefill",
                                                "at": 1000}]


@pytest.mark.parametrize("kw", [dict(replicas=3), dict(replicas=1),
                                dict(replicas=2, fault_config=FAULTS)])
def test_metrics_replica_and_fault_sections_have_the_jax_schema(
        weights, engine, kw):
    want = _jax_sections(weights, **kw)
    app = FlexServeApp(engine=engine,
                       replica_options={"monitor": False}
                       if kw["replicas"] > 1 else None, **kw)
    try:
        got = app.handle("GET", "/metrics", b"")
    finally:
        app.close()
    assert set(got["replicas"]) == set(want["replicas"])
    assert set(got["replicas"]["per_replica"]) == \
        set(want["replicas"]["per_replica"])
    for rid, rep in got["replicas"]["per_replica"].items():
        assert set(rep) == set(want["replicas"]["per_replica"][rid])
    assert got["faults"] == want["faults"]
    assert set(got["generate"]) == set(want["generate"])
    assert set(got["generate"]["replicas"]) == \
        set(want["generate"]["replicas"])
