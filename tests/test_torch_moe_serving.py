"""The moe family (qwen3-moe-235b-a22b with GQA; deepseek-v3-671b with MLA)
through the port's serving entry points, against the JAX package's, on
the CPU.

Same weights (the reduced JAX params carried over with
``params.from_jax``), same prompts: ``InferenceEngine.generate`` greedy and
seeded, the continuous-batching scheduler and ``SchedulerService`` (dense
for both; paged for qwen3-moe, whose paged streams must also equal the
port's dense ones) must be token-identical to the JAX engine's and
scheduler's.  The reduced configs' decode batches never drop (T <= 128
tokens is dropless), so one generate runs a 4 x 64 prefill bucket (T =
256) with zeroed routers: every token ties, goes to experts 0 and 1, and
assignments past the capacity drop, padding included, in JAX's order.
Then a qwen3-moe member behind both packages' servers (/v1/infer and
/v1/generate bodies equal), ``build_app``'s generate plane for moe
members, both configs through ``training/checkpoint.py`` in the JAX
format, and the refusals (speculative pairs of moe models, paged MLA)
beside the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import ContinuousBatchingScheduler as JScheduler
from repro.core import Ensemble as JEnsemble
from repro.core import EnsembleMember as JMember
from repro.core import InferenceEngine as JEngine
from repro.core import ModelRegistry as JRegistry
from repro.core import PagedInferenceEngine as JPaged
from repro.core import SamplingParams as JSamplingParams
from repro.core import SpeculativeEngine as JSpeculative
from repro.core.engine import page_kv_bytes as jpage_kv_bytes
from repro.core.scheduler import SchedulerService as JService
from repro.models import build_model as jbuild_model
from repro.serving import FlexServeApp as JApp
from repro.serving import FlexServeClient
from repro.serving import FlexServeServer as JServer
from repro.training import checkpoint as jck
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (ContinuousBatchingScheduler, Ensemble,
                              EnsembleMember, InferenceEngine, ModelRegistry,
                              PagedInferenceEngine, SamplingParams,
                              SchedulerService, SpeculativeEngine)
from repro_torch.core.engine import page_kv_bytes
from repro_torch.launch.serve import DECODE_FAMILIES, build_app
from repro_torch.models import build_model, moe
from repro_torch.params import flatten, from_jax, state_from_jax, to_flat
from repro_torch.params import unflatten
from repro_torch.serving import FlexServeApp, FlexServeServer, ModelStore
from repro_torch.training import checkpoint as ck


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


QWEN, DSV3 = "qwen3-moe-235b-a22b", "deepseek-v3-671b"
ARCHS = [QWEN, DSV3]
MAX_LEN = 128
C = 8
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7,
               max_new_tokens=12)


def _params(arch, zero_router=False):
    """(JAX params, port params) of the reduced config; ``zero_router``
    zeroes every MoE router (all probabilities tie)."""
    flat = {k: np.asarray(v) for k, v in _flatten(jbuild_model(jreduce(
        jget_config(arch))).init(jax.random.PRNGKey(0))).items()}
    if zero_router:
        flat = {k: np.zeros_like(v) if k.endswith("moe/router") else v
                for k, v in flat.items()}
    return (jax.tree_util.tree_map(jnp.asarray, unflatten(flat)),
            from_jax(flat, "cpu"))


def _models(arch):
    return (jbuild_model(jreduce(jget_config(arch))),
            build_model(reduce_for_smoke(get_config(arch))))


_ENGINES = {}


def engines(arch, kind="dense", zero_router=False):
    """(JAX engine, port engine) over the same params, cached per module
    (the JAX side's jit caches live on the engine)."""
    key = (arch, kind, zero_router)
    if key not in _ENGINES:
        jp, tp = _params(arch, zero_router)
        jmodel, tmodel = _models(arch)
        kw = dict(max_len=MAX_LEN, max_batch=4)
        if kind == "paged":
            _ENGINES[key] = (JPaged(jmodel, jp, page_size=16, **kw),
                             PagedInferenceEngine(tmodel, tp, page_size=16,
                                                  **kw))
        else:
            _ENGINES[key] = (JEngine(jmodel, jp, **kw),
                             InferenceEngine(tmodel, tp, **kw))
    return _ENGINES[key]


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
        want = jeng.generate(prompts, max_new_tokens=12)
        got = teng.generate(prompts, max_new_tokens=12)
    assert got.tokens == want.tokens
    assert got.finish_reasons == want.finish_reasons
    assert got.steps == want.steps


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_with_drops_matches_jax(arch):
    """A 4 x 64 prefill bucket: T = 256 > 128, so C = 160 < 256 tokens on
    each of experts 0 and 1 (zeroed routers tie every expert, and ties go
    to the lower index).  Padded positions route and take capacity, so
    which rows keep their experts depends on the batch: the streams must
    still be JAX's."""
    jeng, teng = engines(arch, zero_router=True)
    cfg = teng.model.config
    prompts = _prompts(cfg.vocab_size, (5, 40, 61, 33), 9)
    T = 4 * 64
    Cap = moe.capacity_for(T, cfg.moe.top_k, cfg.moe.num_experts)
    assert Cap < T
    x2 = torch.randn((T, cfg.d_model))
    r = moe.route({"router": torch.zeros((cfg.d_model,
                                          cfg.moe.num_experts))}, x2, cfg)
    assert int((~r.keep).sum()) == 2 * (T - Cap)
    want = jeng.generate(prompts, max_new_tokens=8)
    got = teng.generate(prompts, max_new_tokens=8)
    assert got.tokens == want.tokens
    assert got.finish_reasons == ["length"] * 4


SPECS = [dict(max_new_tokens=8),
         dict(max_new_tokens=10, temperature=0.8, top_k=50, top_p=0.9,
              seed=7),
         dict(max_new_tokens=6, temperature=1.0, seed=3),
         dict(max_new_tokens=9),
         dict(max_new_tokens=5, temperature=1.2, top_k=8, seed=19)]
KINDS = [(QWEN, "dense"), (QWEN, "paged"), (DSV3, "dense")]


def _drive(sched, prompts, samp_cls):
    reqs = [sched.submit(p, sampling=samp_cls(**sp))
            for p, sp in zip(prompts, SPECS)]
    sched.run()
    return {"streams": [(r.output, r.finish_reason) for r in reqs],
            "ticks": sched.decode_ticks,
            "prefill_forwards": sched.prefill_forwards,
            "prefill_requests": sched.prefill_requests,
            "transfer": sched.decode_transfer_bytes}


@pytest.mark.parametrize("arch,kind", KINDS)
def test_scheduler_streams_match_jax(arch, kind):
    """Five requests, greedy and seeded, on two slots (slots reused; the
    66-token prompt's 2 x 128 prefill group has T = 256 > 128)."""
    jeng, teng = engines(arch, kind)
    prompts = _prompts(jeng.model.config.vocab_size, (5, 17, 3, 66, 9), 2)
    want = _drive(JScheduler(jeng, num_slots=2), prompts, JSamplingParams)
    got = _drive(ContinuousBatchingScheduler(teng, num_slots=2), prompts,
                 SamplingParams)
    assert got == want
    assert all(r == "length" for _, r in got["streams"])


def test_paged_streams_equal_dense():
    """qwen3-moe on the port: the paged scheduler's streams are the dense
    scheduler's, token for token."""
    _, dense = engines(QWEN)
    _, paged = engines(QWEN, "paged")
    prompts = _prompts(dense.model.config.vocab_size, (5, 17, 3, 66, 9), 4)
    got = [_drive(ContinuousBatchingScheduler(e, num_slots=2), prompts,
                  SamplingParams)["streams"] for e in (dense, paged)]
    assert got[0] == got[1]


@pytest.mark.parametrize("arch,kind", KINDS)
def test_service_matches_jax_service(arch, kind):
    jeng, teng = engines(arch, kind)
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
def test_state_batch_axes_and_insert_rows(arch):
    """Every cache leaf (``cache_dense``/``cache``; k/v or ckv/krope) keeps
    batch on axis 1, ``length`` on axis 0, as the JAX engine finds them;
    both engines scatter the same group state into the same pool."""
    jeng, teng = engines(arch)
    axes = dict(flatten(teng.state_batch_axes()))
    assert axes == dict(_flatten(jeng.state_batch_axes()))
    assert axes.pop("length") == 0 and set(axes.values()) == {1}
    if arch == DSV3:
        assert set(axes) == {"cache_dense/ckv", "cache_dense/krope",
                             "cache/ckv", "cache/krope"}
    vocab = jeng.model.config.vocab_size
    _, pool = jeng.prefill({"tokens": jnp.asarray(np.asarray(
        _prompts(vocab, (8, 8, 8, 8), 1), np.int32))}, jeng.new_state(4))
    _, group = jeng.prefill({"tokens": jnp.asarray(np.asarray(
        _prompts(vocab, (8, 8), 2), np.int32)),
        "lengths": jnp.asarray([8, 5], jnp.int32)}, jeng.new_state(2))
    src = np.array([0, 1, 0, 1], np.int32)
    mask = np.array([False, True, True, False])
    want = jeng.insert_rows(pool, group, jnp.asarray(src), jnp.asarray(mask))
    got = to_flat(flatten(teng.insert_rows(state_from_jax(pool, "cpu"),
                                           state_from_jax(group, "cpu"),
                                           src, mask)))
    for k, v in _flatten(want).items():
        np.testing.assert_array_equal(got[k], np.asarray(v))


def test_page_kv_bytes_counts_the_dense_layers():
    """A moe config's ``cache_dense`` pool is indexed by the same pages:
    a page costs every layer's K/V, as JAX counts it and as the pools
    hold it."""
    import dataclasses
    from repro_torch.models import paged
    jcfg = dataclasses.replace(jreduce(jget_config(DSV3)), attn_kind="gqa",
                               mla=None)
    tcfg = dataclasses.replace(reduce_for_smoke(get_config(DSV3)),
                               attn_kind="gqa", mla=None)
    assert tcfg.moe.first_k_dense == 1
    assert page_kv_bytes(tcfg, 16) == jpage_kv_bytes(jcfg, 16)
    state = paged.init_paged_state(tcfg, 2, 5, 16, 4, device="cpu")
    pools = [state[k][kv] for k in ("cache_dense", "cache")
             for kv in ("k", "v")]
    assert page_kv_bytes(tcfg, 16) == sum(
        t[:, 0].numel() * t.element_size() for t in pools)


# --- HTTP ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    """A reduced qwen3-moe member behind the JAX server and the port's,
    same weights, each with a dense generate plane."""
    jp, tp = _params(QWEN)
    jmodel, tmodel = _models(QWEN)
    name = f"{QWEN}#0"
    jreg, treg = JRegistry(), ModelRegistry()
    jreg.register(name, jmodel, jp)
    treg.register(name, tmodel, tp)
    jm = JMember(name, lambda p, b: jmodel.forward(p, b)[:, -1, :C], jp, C)
    tm = EnsembleMember(name, lambda p, b: tmodel.forward(p, b)[:, -1, :C],
                        tp, C)
    kw = dict(max_len=MAX_LEN, max_batch=4)
    japp = JApp(jreg, JEnsemble([jm], max_batch=8),
                JEngine(jmodel, jp, **kw), num_slots=2, trace=False)
    tapp = FlexServeApp(treg, Ensemble([tm], max_batch=8),
                        InferenceEngine(tmodel, tp, **kw), num_slots=2)
    srv = [JServer(japp).start(), FlexServeServer(tapp).start()]
    clients = [FlexServeClient(*s.address) for s in srv]
    yield japp, tapp, clients
    for c in clients:
        c.close()
    for s in srv:
        s.stop()


def test_infer_bodies_equal_the_jax_server(servers):
    japp, tapp, (jc, tc) = servers
    tokens = _prompts(512, (12, 12, 12), 6)
    assert tc.infer({"tokens": tokens}) == jc.infer({"tokens": tokens})
    models = tc.models()["models"]
    assert models == jc.models()["models"]
    assert models[0]["family"] == "moe"
    batch = {"tokens": np.asarray(tokens, np.int32)}
    want = japp.ensemble.forward(batch)
    got = tapp.ensemble.forward(batch)
    for name in want:
        assert_allclose(got[name].numpy(), np.asarray(want[name]),
                        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(max_new_tokens=6),
                                dict(max_new_tokens=8, temperature=0.8,
                                     top_k=50, top_p=0.9, seed=42)])
def test_generate_bodies_equal_the_jax_server(servers, kw):
    _, _, (jc, tc) = servers
    prompts = _prompts(512, (5, 30, 11), 7)
    want = jc.generate(prompts, **kw)
    assert tc.generate(prompts, **kw) == want
    assert want["finish_reasons"] == ["length"] * 3
    # one prompt streamed (a seeded row i draws from seed + i)
    events = list(tc.generate_stream(prompts[1], **kw))
    assert [e["token"] for e in events if e["event"] == "token"] == \
        jc.generate([prompts[1]], **kw)["outputs"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_app_gives_moe_members_the_generate_plane(arch):
    """``build_app`` (reduced, on the CPU) serves a moe member on both
    planes, as the JAX launcher does (``moe`` in DECODE_FAMILIES)."""
    assert "moe" in DECODE_FAMILIES
    app = build_app([arch], device="cpu", num_classes=C, max_len=64,
                    num_slots=2)
    try:
        assert app.generation is not None
        engine = app.generation.engine_for()
        assert engine.model.config.family == "moe"
        assert engine.params is app.registry.get(f"{arch}#0").params
        res = app.generation.entry_for().service.submit_and_wait(
            [[1, 2, 3]], max_new_tokens=4, timeout=60)
        assert len(res.tokens[0]) == 4
        logits = app.ensemble.forward({"tokens": np.ones((2, 5), np.int32)})
        assert tuple(next(iter(logits.values())).shape) == (2, C)
    finally:
        app.close()


# --- checkpoints and refusals --------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trip_in_the_jax_format(arch, tmp_path):
    """Both configs, every tree (``dense_layers``, ``layers/moe/we_*``,
    ``ws_*``, the router, deepseek's ``mtp/*``): a JAX-written checkpoint
    restores into ``Model.like()`` bit for bit, the port's file loads in
    the JAX package, the param hashes agree, and a store publish + load
    round-trips."""
    jp, tp = _params(arch)
    _, tmodel = _models(arch)
    path = jck.save(str(tmp_path / "j.ckpt"), jp, meta={"config": arch})
    got, meta = ck.restore(path, tmodel.like(), device="cpu")
    assert meta["config"] == arch
    assert set(got) == set(tp)
    for k in tp:
        assert torch.equal(got[k], tp[k]), k
    leaves, _ = jck.load(ck.save(str(tmp_path / "t.ckpt"), tp))
    want = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    assert set(leaves) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(leaves[k], v)
    assert ck.param_hash(tp) == jck.param_hash(jp)
    store = ModelStore(str(tmp_path / "store"))
    store.publish(f"{arch}#0", tp, config=arch, meta={"reduced": True})
    loaded, manifest = store.load(f"{arch}#0", 1, tmodel.like())
    assert manifest["param_hash"] == ck.param_hash(tp)
    assert all(torch.equal(loaded[k], tp[k]) for k in tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_engine_refuses_moe_like_jax(arch):
    """The speculative pair takes dense GQA only, in both packages: a moe
    target (GQA or MLA) is refused with the JAX message."""
    jeng, teng = engines(arch)
    with pytest.raises(ValueError) as want:
        JSpeculative(jeng, jeng)
    with pytest.raises(ValueError) as got:
        SpeculativeEngine(teng, teng)
    assert str(got.value) == str(want.value)
    assert "dense GQA transformer" in str(got.value)


def test_paged_engine_refuses_mla_like_jax():
    jeng, teng = engines(DSV3)
    with pytest.raises(ValueError) as want:
        JPaged(jeng.model, jeng.params, max_len=64, page_size=16)
    with pytest.raises(ValueError) as got:
        PagedInferenceEngine(teng.model, teng.params, max_len=64,
                             page_size=16)
    assert str(got.value) == str(want.value)
