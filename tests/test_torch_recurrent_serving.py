"""The recurrent families (rwkv6-1.6b, zamba2-2.7b) through the port's
serving entry points, against the JAX package's, on the CPU.

Same weights (JAX smoke params carried over with ``params.from_jax``;
zamba2's zero-initialised ``lora_b`` perturbed with numpy noise), same
prompts: ``InferenceEngine.generate`` greedy and seeded streams, and the
continuous-batching scheduler's and ``SchedulerService``'s streams, finish
reasons and counters (five requests on two slots, so slots are reused),
must be token-identical to the JAX engine's and scheduler's.
``insert_rows`` scatters the recurrent states' axis-1 leaves as JAX's
does; the paged engine refuses both families.  Then the paper's
heterogeneous ensemble (yi-9b + h2o-danube + rwkv6, tests/test_system.py)
behind both packages' servers: three members, families {dense, ssm}, and
/v1/infer member logits equal to the JAX ensemble's at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from conftest import smoke_model
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import ContinuousBatchingScheduler as JScheduler
from repro.core import Ensemble as JEnsemble
from repro.core import EnsembleMember as JMember
from repro.core import InferenceEngine as JEngine
from repro.core import ModelRegistry as JRegistry
from repro.core import SamplingParams as JSamplingParams
from repro.core.scheduler import SchedulerService as JService
from repro.models import build_model as jbuild_model
from repro.serving import FlexServeApp as JApp
from repro.serving import FlexServeClient
from repro.serving import FlexServeServer as JServer
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (ContinuousBatchingScheduler, Ensemble,
                              EnsembleMember, InferenceEngine, ModelRegistry,
                              PagedInferenceEngine, SamplingParams,
                              SchedulerService)
from repro_torch.launch.serve import build_app
from repro_torch.models import build_model
from repro_torch.params import flatten, from_jax, state_from_jax, to_flat
from repro_torch.params import unflatten
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


ARCHS = ["rwkv6-1.6b", "zamba2-2.7b"]
MAX_LEN = 128          # zamba2's 64-slot shared ring wraps on long prompts
C = 8
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7,
               max_new_tokens=16)


def _params(arch):
    """(JAX params, port params) of the smoke config, lora_b perturbed."""
    flat = {k: np.asarray(v) for k, v in _flatten(jbuild_model(jreduce(
        jget_config(arch))).init(jax.random.PRNGKey(0))).items()}
    if "shared/lora_b" in flat:
        lb = flat["shared/lora_b"]
        flat["shared/lora_b"] = (np.random.default_rng(1).standard_normal(
            lb.shape) * 0.05).astype(lb.dtype)
    return (jax.tree_util.tree_map(jnp.asarray, unflatten(flat)),
            from_jax(flat, "cpu"))


_ENGINES = {}


def engines(arch):
    """(JAX engine, port engine) over the same params, cached per module
    (the JAX side's jit caches live on the engine)."""
    if arch not in _ENGINES:
        jp, tp = _params(arch)
        kw = dict(max_len=MAX_LEN, max_batch=4)
        _ENGINES[arch] = (
            JEngine(jbuild_model(jreduce(jget_config(arch))), jp, **kw),
            InferenceEngine(build_model(reduce_for_smoke(get_config(arch))),
                            tp, **kw))
    return _ENGINES[arch]


def _prompts(vocab, lengths=(5, 17, 70), seed=5):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, (n,)).tolist() for n in lengths]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sampled", [False, True])
def test_generate_matches_jax_engine(arch, sampled):
    jeng, teng = engines(arch)
    prompts = _prompts(jeng.model.config.vocab_size)
    if sampled:
        want = jeng.generate(prompts, sampling=JSamplingParams(**SAMPLED))
        got = teng.generate(prompts, sampling=SamplingParams(**SAMPLED))
    else:
        want = jeng.generate(prompts, max_new_tokens=16)
        got = teng.generate(prompts, max_new_tokens=16)
    assert got.tokens == want.tokens
    assert got.finish_reasons == want.finish_reasons
    assert got.steps == want.steps


SPECS = [dict(max_new_tokens=8),
         dict(max_new_tokens=10, temperature=0.8, top_k=50, top_p=0.9,
              seed=7),
         dict(max_new_tokens=6, temperature=1.0, seed=3),
         dict(max_new_tokens=9),
         dict(max_new_tokens=5, temperature=1.2, top_k=8, seed=19)]


def _drive(sched, prompts, samp_cls):
    reqs = [sched.submit(p, sampling=samp_cls(**sp))
            for p, sp in zip(prompts, SPECS)]
    sched.run()
    return {"streams": [(r.output, r.finish_reason) for r in reqs],
            "ticks": sched.decode_ticks,
            "prefill_forwards": sched.prefill_forwards,
            "prefill_requests": sched.prefill_requests,
            "transfer": sched.decode_transfer_bytes}


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_streams_match_jax(arch):
    """Five requests, greedy and seeded, on two slots: slots are reused,
    so a finished row's recurrent state is overwritten by the next
    admission's ``insert_rows``."""
    jeng, teng = engines(arch)
    prompts = _prompts(jeng.model.config.vocab_size, (5, 17, 3, 66, 9), 2)
    want = _drive(JScheduler(jeng, num_slots=2), prompts, JSamplingParams)
    got = _drive(ContinuousBatchingScheduler(teng, num_slots=2), prompts,
                 SamplingParams)
    assert got == want
    assert all(r == "length" for _, r in got["streams"])
    assert got["prefill_requests"] == 5 and got["ticks"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_service_matches_jax_service(arch):
    jeng, teng = engines(arch)
    prompts = _prompts(jeng.model.config.vocab_size, (4, 21, 9), 3)
    samp = dict(max_new_tokens=7, temperature=0.9, top_k=40, seed=12)
    out = []
    for svc_cls, samp_cls, eng in ((JService, JSamplingParams, jeng),
                                   (SchedulerService, SamplingParams, teng)):
        svc = svc_cls(eng, num_slots=2)
        try:
            r = svc.submit_and_wait(prompts, sampling=samp_cls(**samp),
                                    timeout=120)
            out.append((r.tokens, r.finish_reasons))
        finally:
            svc.close()
    assert out[1] == out[0]
    assert out[1][1] == ["length"] * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_insert_rows_on_axis_one_leaves(arch):
    """Every per-layer leaf keeps batch on axis 1 (``length`` on axis 0);
    both engines scatter the same group state into the same pool, and the
    pool passed in is left as it was."""
    jeng, teng = engines(arch)
    axes = dict(teng.state_batch_axes())
    assert axes == jeng.state_batch_axes()
    assert axes.pop("length") == 0 and set(axes.values()) == {1}
    vocab = jeng.model.config.vocab_size
    pool = jeng.new_state(4)
    _, pool = jeng.prefill({"tokens": jnp.asarray(np.asarray(
        _prompts(vocab, (8, 8, 8, 8), 1), np.int32))}, pool)
    group = jeng.new_state(2)
    _, group = jeng.prefill({"tokens": jnp.asarray(np.asarray(
        _prompts(vocab, (8, 8), 2), np.int32)),
        "lengths": jnp.asarray([8, 5], jnp.int32)}, group)
    src = np.array([0, 1, 0, 1], np.int32)
    mask = np.array([False, True, True, False])
    tpool, tgroup = state_from_jax(pool, "cpu"), state_from_jax(group, "cpu")
    before = to_flat(flatten(tpool))
    want = jeng.insert_rows(pool, group, jnp.asarray(src), jnp.asarray(mask))
    got = to_flat(flatten(teng.insert_rows(tpool, tgroup, src, mask)))
    for k, v in _flatten(want).items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
    for k, v in to_flat(flatten(tpool)).items():
        np.testing.assert_array_equal(v, before[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses_recurrent_families(arch):
    _, teng = engines(arch)
    with pytest.raises(ValueError, match="no paged KV path"):
        PagedInferenceEngine(teng.model, teng.params, max_len=64,
                             page_size=16)


# --- the paper's heterogeneous ensemble ---------------------------------------

HETERO = ["yi-9b", "h2o-danube-1.8b", "rwkv6-1.6b"]


@pytest.fixture(scope="module")
def hetero():
    """The JAX and the port's three-member ensembles behind their servers,
    same weights (tests/test_system.py's deployment)."""
    jreg, treg, jm, tm = JRegistry(), ModelRegistry(), [], []
    for i, arch in enumerate(HETERO):
        _, jmodel, jp = smoke_model(arch)
        tmodel = build_model(reduce_for_smoke(get_config(arch)))
        tp = from_jax(_flatten(jp), "cpu")
        name = f"{arch}#{i}"
        jreg.register(name, jmodel, jp)
        treg.register(name, tmodel, tp)
        jm.append(JMember(name, lambda p, b, _m=jmodel:
                          _m.forward(p, b)[:, -1, :C], jp, C))
        tm.append(EnsembleMember(name, lambda p, b, _m=tmodel:
                                 _m.forward(p, b)[:, -1, :C], tp, C))
    japp = JApp(jreg, JEnsemble(jm, max_batch=8), trace=False)
    tapp = FlexServeApp(treg, Ensemble(tm, max_batch=8))
    servers = [JServer(japp).start(), FlexServeServer(tapp).start()]
    clients = [FlexServeClient(*s.address) for s in servers]
    yield japp, tapp, clients
    for c in clients:
        c.close()
    for s in servers:
        s.stop()


def test_heterogeneous_ensemble_behind_one_endpoint(hetero):
    japp, tapp, (jc, tc) = hetero
    models = tc.models()["models"]
    assert len(models) == 3
    assert {m["family"] for m in models} == {"dense", "ssm"}
    assert models == jc.models()["models"]
    tokens = [[1, 2, 3, 4, 5, 6], [400, 3, 77, 18, 250, 9]]
    body = tc.infer({"tokens": tokens})
    assert {"model_0", "model_1", "model_2", "ensemble"} <= set(body)
    batch = {"tokens": np.asarray(tokens, np.int32)}
    want = japp.ensemble.forward(batch)
    got = tapp.ensemble.forward(batch)
    assert set(got) == set(want) == {f"{a}#{i}" for i, a in enumerate(HETERO)}
    for name in want:
        assert_allclose(got[name].numpy(), np.asarray(want[name]),
                        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("archs", [HETERO, ARCHS])
def test_build_app_serves_recurrent_members(archs):
    """The launcher's ``build_app`` builds the recurrent members (reduced,
    on the CPU) and one coalesced forward answers /v1/infer."""
    app = build_app(archs, device="cpu", num_classes=C)
    families = {m["family"] for m in app.registry.describe()}
    assert families == {get_config(a).family for a in archs}
    srv = FlexServeServer(app).start()
    try:
        client = FlexServeClient(*srv.address)
        body = client.infer({"tokens": [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]})
        client.close()
    finally:
        srv.stop()
    for i in range(len(archs)):
        assert len(body[f"model_{i}"]) == 2
    logits = app.ensemble.forward({"tokens": np.ones((3, 7), np.int32)})
    assert all(tuple(v.shape) == (3, C) and bool(torch.isfinite(v).all())
               for v in logits.values())
