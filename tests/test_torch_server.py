"""The port's REST server against the JAX package's, on the CPU.

Both servers hold a two-member reduced yi-9b ensemble with the same
weights (JAX init, carried over with ``params.from_jax``) and a generate
engine over member 0, and get the same requests in the same order; their
bodies on /health, /healthz, /v1/models, /v1/infer, /v1/detect,
/v1/generate and /v1/replicas must be equal, and the control plane's
routes must answer with the JAX server's status and keys.  The token batches are
fixed and their decisions sit far from any tie (checked below), so
summation order cannot flip a class.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.core import Ensemble as JEnsemble
from repro.core import EnsembleMember as JMember
from repro.core import InferenceEngine as JEngine
from repro.core import ModelRegistry as JRegistry
from repro.serving import FlexServeApp as JApp
from repro.serving import FlexServeClient
from repro.serving import FlexServeServer as JServer
from repro.serving.client import HTTPStatusError
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (Ensemble, EnsembleMember, InferenceEngine,
                              ModelRegistry)
from repro_torch.launch import serve
from repro_torch.launch.serve import build_app, main
from repro_torch.models import build_model
from repro_torch.params import from_jax
from repro_torch.serving import FlexServeApp, FlexServeServer


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


C = 8


def _apps():
    cfg, jmodel, _ = smoke_model("yi-9b")
    tmodel = build_model(reduce_for_smoke(get_config("yi-9b")))
    jreg, treg, jm, tm = JRegistry(), ModelRegistry(), [], []
    for i in range(2):
        jp = jmodel.init(jax.random.PRNGKey(i))
        tp = from_jax(_flatten(jp), "cpu")
        jreg.register(f"yi#{i}", jmodel, jp)
        treg.register(f"yi#{i}", tmodel, tp)
        jm.append(JMember(f"yi#{i}", lambda p, b, _m=jmodel:
                          _m.forward(p, b)[:, -1, :C], jp, C))
        tm.append(EnsembleMember(f"yi#{i}", lambda p, b, _m=tmodel:
                                 _m.forward(p, b)[:, -1, :C], tp, C))
    # the generate plane over member 0's params, as build_app does
    jeng = JEngine(jmodel, jm[0].params, max_len=64, max_batch=8)
    teng = InferenceEngine(tmodel, tm[0].params, max_len=64, max_batch=8)
    japp = JApp(jreg, JEnsemble(jm, max_batch=8), jeng)
    tapp = FlexServeApp(treg, Ensemble(tm, max_batch=8), teng)
    return japp, tapp


@pytest.fixture(scope="module")
def clients():
    japp, tapp = _apps()
    servers = [JServer(japp).start(), FlexServeServer(tapp).start()]
    cls = [FlexServeClient(*s.address) for s in servers]
    yield cls
    for c in cls:
        c.close()
    for s in servers:
        s.stop()


TOKENS = [[[1, 2, 3, 4], [5, 6, 7, 8]], [[9, 10, 11, 12, 13, 14]] * 3,
          [[400, 3, 77, 18, 250]]]


def test_bodies_equal_the_jax_server(clients):
    jc, tc = clients
    calls = [("health", ()), ("healthz", ()), ("models", ())]
    for toks in TOKENS:
        for policy in ("soft_vote", "hard_vote", "max_confidence"):
            calls.append(("infer", ({"tokens": toks}, policy)))
        for policy in ("or", "and", "majority"):
            calls.append(("detect", ({"tokens": toks}, 1, policy, 0.05)))
    calls.append(("health", ()))
    for name, args in calls:
        want = getattr(jc, name)(*args)
        got = getattr(tc, name)(*args)
        assert got == want, (name, args)


def test_decisions_are_far_from_ties():
    """The premise of exact body equality: every member's top-2 class
    margin and detection margin on TOKENS exceed 1e-3."""
    japp, tapp = _apps()
    japp.close()
    for toks in TOKENS:
        probs = tapp.ensemble.probs({"tokens": np.asarray(toks, np.int32)})
        for p in probs.values():
            top = np.sort(p, -1)
            assert ((top[:, -1] - top[:, -2]) > 1e-3).all()
            assert (np.abs(p[:, 1] - 0.05) > 1e-3).all()
    tapp.close()


def test_concurrent_infers_coalesce(clients):
    _, tc = clients
    before = tc.metrics()["coalesce"]["batches_formed"]
    n = 8
    with concurrent.futures.ThreadPoolExecutor(n) as ex:
        outs = list(ex.map(lambda i: tc.infer({"tokens": [[i + 1, 2, 3]]}),
                           range(n)))
    assert all(len(o["model_0"]) == 1 for o in outs)
    m = tc.metrics()
    assert m["coalesce"]["batches_formed"] - before < n
    assert set(m["ensemble_compiles"]) <= {"1", "2", "4", "8"}
    assert set(m) >= {"uptime_s", "requests", "routes", "coalesce",
                      "admission"}


def _stable(body):
    """A body with the replica summary's wall-clock reading masked."""
    for rep in body.get("per_replica", {}).values():
        rep["last_tick_ms"] = None
    return body


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/v1/generate", {"prompts": [[1, 2, 3], [7, 8]],
                              "max_new_tokens": 4}),
    ("POST", "/v1/generate", {"prompts": [[5, 6, 7]], "max_new_tokens": 5,
                              "temperature": 0.8, "top_k": 50,
                              "top_p": 0.9, "seed": 42}),
    ("GET", "/v1/replicas", None)])
def test_generate_plane_bodies_equal_the_jax_server(clients, method, path,
                                                    body):
    """The routes that answered 501 before the generate plane was ported
    now answer as the JAX server does."""
    jc, tc = clients
    want = _stable(jc._request(method, path, body))
    got = _stable(tc._request(method, path, body))
    assert got == want


CONTROL_PLANE = [("POST", "/v1/engines/x/load"), ("GET", "/v1/engines"),
                 ("GET", "/v1/models/yi%230"), ("GET", "/v1/traces"),
                 ("GET", "/v1/usage"), ("GET", "/v1/slo"),
                 ("POST", "/v1/debug/profile")]


def _answer(client, method, path):
    """(status, top-level keys or the error's code) of one request."""
    try:
        body = client._request(method, path,
                               {} if method == "POST" else None, retries=0)
    except HTTPStatusError as e:
        return e.status, e.code
    return 200, sorted(body) if isinstance(body, dict) else type(body)


@pytest.mark.parametrize("method,path", CONTROL_PLANE)
def test_control_plane_routes_answer_as_the_jax_server(clients, method,
                                                       path):
    """The routes that answered 501 before the control plane was ported
    answer with the JAX server's status and keys (no manager and no
    profile directory on these endpoints: 503 where JAX says so)."""
    jc, tc = clients
    assert _answer(tc, method, path) == _answer(jc, method, path)


def _draft_store(store_cls, root, init):
    """``det`` v1 and a 1-layer ``det#draft`` v1 (its depth in the
    manifest), params from ``init(config, seed)``."""
    import dataclasses
    store = store_cls(str(root))
    cfg = reduce_for_smoke(get_config("yi-9b"))
    meta = {"reduced": True, "num_classes": 4, "max_len": 64,
            "max_batch": 2}
    store.publish("det", init(cfg, 0), config="yi-9b", source=cfg.source,
                  meta=meta)
    store.publish("det#draft", init(dataclasses.replace(cfg, num_layers=1),
                                    1000), config="yi-9b",
                  source=cfg.source, meta={**meta, "num_layers": 1})
    return store


def test_engine_load_with_a_draft_answers_as_the_jax_server(tmp_path):
    """``"draft"`` on POST /v1/engines/{name}/load loads the speculative
    pair: 200 with the JAX server's keys, and the pair's ``speculative`` /
    ``draft`` fields as the JAX manager's ``load_engine(draft=...)`` gives
    them (the JAX route itself drops the field and loads the target
    alone); a stream on the pair then carries its speculation summary."""
    from repro.models.build import build_model as jbuild
    from repro.serving import GenerationService as JGen
    from repro.serving import ModelManager as JManager
    from repro.serving import ModelStore as JStore
    from repro_torch.serving import (GenerationService, ModelManager,
                                     ModelStore)
    jstore = _draft_store(JStore, tmp_path / "jax", lambda c, seed: jbuild(
        c).init(jax.random.PRNGKey(seed)))
    tstore = _draft_store(ModelStore, tmp_path / "torch",
                          lambda c, seed: build_model(c).init(seed, "cpu"))
    body = {"draft": "det#draft", "warm": False}
    answers, servers = [], []
    jmgr = JManager(jstore, max_batch=2)
    for mgr, gen, app_cls, srv_cls in (
            (jmgr, JGen(num_slots=2), JApp, JServer),
            (ModelManager(tstore, max_batch=2, device="cpu"),
             GenerationService(num_slots=2), FlexServeApp,
             FlexServeServer)):
        mgr.attach_generation(gen)
        srv = srv_cls(app_cls(manager=mgr)).start()
        servers.append(srv)
        c = FlexServeClient(*srv.address)
        answers.append(c._request("POST", "/v1/engines/det/load", body))
        c.close()
    try:
        jres, tres = answers
        assert sorted(tres) == sorted(jres)
        assert not jres["speculative"] and jres["draft"] is None
        want = jmgr.load_engine("det", 1, draft="det#draft", warm=False)
        for key in ("name", "version", "speculative", "draft", "alias",
                    "engine"):
            assert tres[key] == want[key], key
        assert tres["speculative"] and tres["draft"] == "det#draft@v1"
        c = FlexServeClient(*servers[1].address)
        done = list(c.generate_stream([3, 1, 4], max_new_tokens=6))[-1]
        c.close()
        assert done["event"] == "done" and done["token_count"] == 6
        assert done["speculation"]["proposed"] > 0
    finally:
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/nope", None),
    ("POST", "/v1/infer", {"inputs": {}}),
    ("POST", "/v1/infer", {"inputs": {"tokens": [[1, 2]] * 9}}),
    ("POST", "/v1/infer", {"inputs": {"tokens": [[1, 2]]}, "policy": "or"}),
    ("POST", "/v1/detect", {"inputs": {"tokens": [[1, 2]]}}),
    ("POST", "/v1/detect", {"inputs": {"tokens": [[1, 2]]},
                            "positive_class": 1, "policy": "nope"}),
    ("POST", "/v1/infer", {"inputs": {"tokens": [[1]]}, "priority": "x"}),
    ("POST", "/v1/detect", {"inputs": {"tokens": [[1]]}, "positive_class": 1,
                            "target": "canary"})])
def test_errors_match_the_jax_server(clients, method, path, body):
    got = []
    for c in clients:
        with pytest.raises(HTTPStatusError) as e:
            c._request(method, path, body, retries=0)
        got.append((e.value.status, e.value.code, e.value.retryable))
    assert got[1] == got[0]


def test_build_app_needs_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_app(["yi-9b"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--ensemble", "yi-9b", "--num-slots", "2"])


def test_build_app_on_cpu_serves():
    app = build_app(["yi-9b", "yi-9b"], device="cpu", num_classes=4,
                    max_batch=4, seed=3)
    try:
        assert app.registry.names() == ["yi-9b#0", "yi-9b#1"]
        resp = app.handle("POST", "/v1/infer",
                          b'{"inputs": {"tokens": [[1, 2, 3]]}}').payload
        assert set(resp) == {"model_0", "model_1", "ensemble", "policy"}
        assert all(p.device.type == "cpu"
                   for p in app.ensemble.members[0].params.values())
    finally:
        app.close()


@pytest.mark.parametrize("store", [False, True])
def test_launcher_draft_flags_reach_the_builders(monkeypatch, tmp_path,
                                                 store):
    """``--draft-model``, ``--draft-layers`` and ``--spec-window`` reach
    ``build_app`` (or ``build_store_app`` with ``--model-store``); an arch
    outside the catalog is refused."""
    seen = {}

    def fake(*names, **kw):
        seen.update(kw, names=names)
        raise KeyboardInterrupt

    monkeypatch.setattr(serve, "build_store_app" if store else "build_app",
                        fake)
    argv = ["--ensemble", "yi-9b", "--device", "cpu", "--draft-model",
            "yi-9b", "--draft-layers", "8", "--spec-window", "2"]
    if store:
        argv += ["--model-store", str(tmp_path)]
    with pytest.raises(KeyboardInterrupt):
        main(argv)
    assert (seen["draft_model"], seen["draft_layers"],
            seen["spec_window"]) == ("yi-9b", 8, 2)
    with pytest.raises(SystemExit):
        main(["--draft-model", "no-such-arch"])


def test_build_app_serves_a_speculative_pair_on_cpu():
    """``build_app(draft_model=...)``: the generate plane runs a
    ``SpeculativeEngine`` over member 0 and a draft cut to
    ``draft_layers``, seeded ``seed + 1000``; a seeded stream equals the
    opted-out one and reports its speculation."""
    import dataclasses
    from repro_torch.core import SpeculativeEngine
    app = build_app(["yi-9b"], device="cpu", num_classes=4, max_batch=4,
                    max_len=64, num_slots=2, seed=3, draft_model="yi-9b",
                    draft_layers=1, spec_window=2)
    try:
        eng = app.generation.engine_for()
        assert isinstance(eng, SpeculativeEngine)
        assert eng.max_window == 2 and eng.spec_levels == [1, 2]
        assert eng.params is app.registry.get("yi-9b#0").params
        dcfg = dataclasses.replace(reduce_for_smoke(get_config("yi-9b")),
                                   num_layers=1)
        want = build_model(dcfg).init(1003, "cpu")
        assert eng.draft.model.config.num_layers == 1
        assert all(torch.equal(want[k], v)
                   for k, v in eng.draft.params.items())
        outs = []
        for spec in ("true", "false"):
            resp = app.handle(
                "POST", "/v1/generate",
                ('{"prompts": [[1, 2, 3]], "max_new_tokens": 6, '
                 '"temperature": 0.8, "seed": 5, "speculation": %s}'
                 % spec).encode()).payload
            outs.append(resp["outputs"])
        assert outs[0] == outs[1]
        st = app.generation.stats()["speculation"]
        assert st["enabled"] and st["spec_ticks"] > 0
    finally:
        app.close()


def test_build_store_app_publishes_the_draft(tmp_path):
    """``build_store_app(draft_model=...)`` publishes ``{arch}#draft`` with
    its depth in the manifest and loads the pair as one engine entry."""
    app = serve.build_store_app(["yi-9b"], str(tmp_path), device="cpu",
                                num_classes=4, max_batch=2, num_slots=2,
                                max_len=64, draft_model="yi-9b",
                                draft_layers=1)
    try:
        m = app.manager.store.manifest("yi-9b#draft", 1)
        assert m["num_layers"] == 1 and m["init_seed"] == 1000
        st = app.manager.stats()
        assert st["engine_drafts"] == {"stable": "yi-9b#draft@v1"}
        assert app.generation.engine_for().speculative
    finally:
        app.close()


def test_launcher_generate_flags_reach_build_app(monkeypatch):
    seen = {}

    def fake_build_app(names, **kw):
        seen.update(kw, names=names)
        raise KeyboardInterrupt

    monkeypatch.setattr(serve, "build_app", fake_build_app)
    with pytest.raises(KeyboardInterrupt):
        main(["--ensemble", "yi-9b", "--device", "cpu", "--max-len", "96",
              "--num-slots", "6", "--replicas", "2", "--fault-config",
              "f.json", "--generate-token-budget", "500",
              "--client-weight", "gold=3", "--client-weight", "bronze=1"])
    assert seen["names"] == ["yi-9b"]
    assert (seen["max_len"], seen["num_slots"], seen["replicas"],
            seen["fault_config"], seen["generate_token_budget"]) == \
        (96, 6, 2, "f.json", 500)
    assert seen["client_weights"] == {"gold": 3.0, "bronze": 1.0}
    with pytest.raises(SystemExit):
        main(["--client-weight", "gold"])


def test_build_app_generate_plane_over_member_0_on_cpu():
    app = build_app(["yi-9b", "yi-9b"], device="cpu", num_classes=4,
                    max_batch=4, max_len=64, num_slots=2, seed=3)
    try:
        eng = app.generation.engine_for()
        member = app.registry.get("yi-9b#0")
        assert eng.params is member.params         # no second copy
        assert (eng.max_len, app.generation.num_slots) == (64, 2)
        resp = app.handle("POST", "/v1/generate",
                          b'{"prompts": [[1, 2, 3]], "max_new_tokens": 3}'
                          ).payload
        assert resp["finish_reasons"] == ["length"]
        assert len(resp["outputs"][0]) == 3
    finally:
        app.close()


@pytest.fixture(scope="module")
def spec_client():
    """An endpoint whose generation engine is a speculative pair: the
    reduced yi-9b target and a 1-layer draft (the JAX package's
    ``spec_server``), on the CPU."""
    import dataclasses
    from repro_torch.core import SpeculativeEngine
    from repro_torch.serving import FlexServeClient as TClient
    cfg = reduce_for_smoke(get_config("yi-9b"))
    model = build_model(cfg)
    dmodel = build_model(dataclasses.replace(cfg, num_layers=1))
    params = model.init(0, "cpu")
    registry = ModelRegistry()
    registry.register("yi#0", model, params)
    engine = SpeculativeEngine(
        InferenceEngine(model, params, max_len=64, max_batch=4),
        InferenceEngine(dmodel, dmodel.init(11, "cpu"), max_len=64,
                        max_batch=4),
        max_window=4)
    srv = FlexServeServer(FlexServeApp(registry, None, engine,
                                       num_slots=2)).start()
    client = TClient(*srv.address)
    yield client
    client.close()
    srv.stop()


def test_speculative_stream_summary_and_metrics(spec_client):
    """Over HTTP: the stream's done event carries the acceptance summary,
    ``/metrics`` exposes generate.speculation (the JAX key set), the
    Prometheus exposition flattens it, and an opted-out request streams the
    same tokens with zero speculative work."""
    from repro.core.scheduler import ZERO_SPECULATION_STATS as JZERO
    events = list(spec_client.generate_stream([3, 1, 4, 1, 5],
                                              max_new_tokens=8, seed=13))
    done = events[-1]
    assert done["event"] == "done"
    spec = done["speculation"]
    assert spec["proposed"] > 0
    assert 0.0 <= spec["acceptance_rate"] <= 1.0
    assert spec["accepted"] <= spec["proposed"]
    opt_out = list(spec_client.generate_stream([3, 1, 4, 1, 5],
                                               max_new_tokens=8, seed=13,
                                               speculation=False))
    assert opt_out[-1]["event"] == "done"
    assert opt_out[-1]["tokens"] == done["tokens"]
    assert opt_out[-1]["speculation"] == {
        "proposed": 0, "accepted": 0, "acceptance_rate": 0.0}
    sp = spec_client.metrics()["generate"]["speculation"]
    assert set(sp) == set(JZERO)
    assert sp["enabled"] is True
    assert sp["spec_ticks"] > 0
    assert sp["proposed_tokens"] >= spec["proposed"]
    assert sp["max_window"] == 4
    text = spec_client.metrics(format="prometheus")
    for key in ("proposed_tokens", "accepted_tokens", "acceptance_ema",
                "spec_ticks", "window"):
        assert f"flexserve_generate_speculation_{key}" in text
