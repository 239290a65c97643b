"""The port's REST server against the JAX package's, on the CPU.

Both servers hold a two-member reduced yi-9b ensemble with the same
weights (JAX init, carried over with ``params.from_jax``) and get the same
requests in the same order; their bodies on /health, /healthz,
/v1/models, /v1/infer and /v1/detect must be equal.  The token batches are
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
from repro.core import ModelRegistry as JRegistry
from repro.serving import FlexServeApp as JApp
from repro.serving import FlexServeClient
from repro.serving import FlexServeServer as JServer
from repro.serving.client import HTTPStatusError
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import Ensemble, EnsembleMember, ModelRegistry
from repro_torch.launch.serve import build_app, main
from repro_torch.models import build_model
from repro_torch.params import from_jax
from repro_torch.serving import FlexServeApp, FlexServeServer

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
    japp = JApp(jreg, JEnsemble(jm, max_batch=8), trace=False)
    tapp = FlexServeApp(treg, Ensemble(tm, max_batch=8))
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
    _, tapp = _apps()
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


@pytest.mark.parametrize("method,path", [
    ("POST", "/v1/generate"), ("GET", "/v1/engines"),
    ("GET", "/v1/replicas"), ("GET", "/v1/models/yi%230"),
    ("GET", "/v1/traces"), ("GET", "/v1/usage"), ("GET", "/v1/slo"),
    ("POST", "/v1/debug/profile")])
def test_not_ported_routes_answer_structured_501(clients, method, path):
    _, tc = clients
    with pytest.raises(HTTPStatusError) as e:
        tc._request(method, path, {} if method == "POST" else None)
    assert e.value.status == 501
    assert e.value.code == "not_ported"
    assert "not ported" in str(e.value)


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


def test_build_app_on_cpu_serves():
    app = build_app(["yi-9b", "yi-9b"], device="cpu", num_classes=4,
                    max_batch=4, seed=3)
    try:
        assert app.registry.names() == ["yi-9b#0", "yi-9b#1"]
        resp = app.handle("POST", "/v1/infer",
                          b'{"inputs": {"tokens": [[1, 2, 3]]}}')
        assert set(resp) == {"model_0", "model_1", "ensemble", "policy"}
        assert all(p.device.type == "cpu"
                   for p in app.ensemble.members[0].params.values())
    finally:
        app.close()


def test_launcher_rejects_flags_of_planes_not_ported():
    for flag in (["--num-slots", "4"], ["--model-store", "x"],
                 ["--replicas", "2"], ["--draft-model", "yi-9b"]):
        with pytest.raises(SystemExit):
            main(flag)
