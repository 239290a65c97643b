"""The port's model lifecycle, on the CPU: the contracts of
``tests/test_lifecycle.py`` (versioned registry, hot load/unload/swap
under traffic, the provenance-aware admin API, the engine plane, retention
GC, readiness; the store's own contracts are in
``tests/test_torch_modelstore.py``), what is the port's own (meta-device
shapes, memory released on unload), the speculative pair's lifecycle
against the JAX manager's decisions, and the
slice as a whole: a JAX and a port store-backed app over ONE store
directory take infer -> load v2 -> infer -> rollback -> infer, with equal
decisions and versions and probabilities within 1e-4.

The headline scenario (acceptance): an open-loop client hammers /v1/infer
while the admin API loads a new version, warms it, swaps it in, and
retires the old one — with ZERO failed requests and the active version's
manifest visible at GET /v1/models/{name} before and after.
"""

import concurrent.futures
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.launch import serve as jserve
from repro.serving import FlexServeClient as JClient
from repro.serving import FlexServeServer as JServer
from repro.serving import ModelStore as JStore
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import (Ensemble, EnsembleMember, InferenceEngine,
                              ModelRegistry, SamplingParams)
from repro_torch.launch import serve
from repro_torch.models.build import build_model
from repro_torch.serving import (FlexServeApp, FlexServeClient,
                                 FlexServeServer, GenerationService,
                                 LifecycleError, ModelManager, ModelStore,
                                 default_factory)


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


ARCH = "yi-9b"


def _model():
    return build_model(reduce_for_smoke(get_config(ARCH)))


def _publish_versions(store, name, n, num_classes=8):
    model = _model()
    for seed in range(n):
        store.publish(name, model.init(seed, "cpu"), config=ARCH,
                      source=model.config.source,
                      meta={"reduced": True, "num_classes": num_classes})
    return model


def smoke_params():
    model = _model()
    return model, model.init(0, "cpu")


def test_registry_versions_and_latest():
    model, params = smoke_params()
    reg = ModelRegistry()
    reg.register("m", model, params, version=1)
    reg.register("m", model, params, version=3)
    assert reg.versions("m") == [1, 3]
    assert reg.get("m").version == 3               # latest wins
    assert reg.get("m", 1).version == 1
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m", model, params, version=3)
    with pytest.raises(KeyError, match="no version 2"):
        reg.get("m", 2)
    rows = reg.describe()
    assert [r["version"] for r in rows] == [1, 3]


def test_registry_unregister_raises_on_unknown():
    model, params = smoke_params()
    reg = ModelRegistry()
    with pytest.raises(KeyError, match="not registered"):
        reg.unregister("ghost")
    reg.register("m", model, params, version=1)
    with pytest.raises(KeyError, match="no version 7"):
        reg.unregister("m", 7)
    reg.unregister("m", 1)
    assert len(reg) == 0
    with pytest.raises(KeyError):
        reg.unregister("m", 1)                     # double-unload surfaces


def test_registry_reads_race_free_under_churn():
    """get()/describe() snapshot under the lock while another thread
    registers/unregisters — no RuntimeError (dict changed size) and no
    torn reads (regression: unlocked _models reads)."""
    model, params = smoke_params()
    reg = ModelRegistry()
    reg.register("keep", model, params)
    stop = threading.Event()
    errors = []

    def churn():
        i = 0
        while not stop.is_set():
            reg.register(f"m{i % 8}", model, params, version=i)
            i += 1
            if i % 8 == 0:
                for j in range(8):
                    reg.unregister(f"m{j}")

    def read():
        try:
            while not stop.is_set():
                reg.describe()
                reg.get("keep")
                reg.names()
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=churn)] + \
              [threading.Thread(target=read) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    assert not errors


# --- ModelManager -------------------------------------------------------------


@pytest.fixture(scope="module")
def store_with_versions(tmp_path_factory):
    root = tmp_path_factory.mktemp("modelstore")
    store = ModelStore(str(root))
    _publish_versions(store, "det", 2)
    return store


def _manager(store):
    return ModelManager(store, max_batch=4, device="cpu").bootstrap(["det"])


def test_manager_bootstrap_serves_latest(store_with_versions):
    mgr = _manager(store_with_versions)
    assert mgr.ready
    assert mgr.stats()["aliases"] == {"stable": {"det": 2}}
    out = mgr.forward({"tokens": np.ones((1, 8), np.int32)})
    assert set(out) == {"det"}


def test_manager_swap_changes_served_params(store_with_versions):
    mgr = _manager(store_with_versions)
    batch = {"tokens": np.arange(8, dtype=np.int32).reshape(1, 8)}
    before = np.asarray(mgr.forward(batch)["det"])
    res = mgr.load("det", 1)
    assert res["previous_version"] == 2 and res["drained"]
    after = np.asarray(mgr.forward(batch)["det"])
    assert not np.allclose(before, after)      # different version, different logits
    # rollback restores v2's outputs exactly
    res = mgr.rollback("det")
    assert res["rolled_back_to"] == 2
    again = np.asarray(mgr.forward(batch)["det"])
    np.testing.assert_allclose(again, before)


def test_manager_unload_refuses_active_version(store_with_versions):
    mgr = _manager(store_with_versions)
    with pytest.raises(LifecycleError, match="active in alias"):
        mgr.unload("det", 2)
    mgr.load("det", 1)
    mgr.unload("det", 2)                       # now inactive: fine
    assert mgr.registry.versions("det") == [1]
    with pytest.raises(LifecycleError, match="would empty"):
        mgr.unload("det")                      # last member must keep serving


def test_manager_alias_canary(store_with_versions):
    mgr = _manager(store_with_versions)
    mgr.load("det", 1, alias="canary")
    assert mgr.aliases() == ["canary", "stable"]
    batch = {"tokens": np.ones((1, 8), np.int32)}
    stable = np.asarray(mgr.forward(batch)["det"])
    canary = np.asarray(mgr.forward(batch, "canary")["det"])
    assert not np.allclose(stable, canary)
    with pytest.raises(LifecycleError, match="no alias"):
        mgr.forward(batch, "ghost")
    traffic = mgr.stats()["per_version"]
    assert traffic["det@v2"]["rows"] >= 1
    assert traffic["det@v1"]["rows"] >= 1


def test_manager_member_unload_is_atomic(tmp_path):
    """A refused whole-member unload must change NOTHING: validation of
    every alias happens before any membership swap (regression: stable
    lost the member while canary's emptiness check raised)."""
    store = ModelStore(str(tmp_path))
    _publish_versions(store, "det", 1)
    _publish_versions(store, "aux", 1)
    mgr = ModelManager(store, max_batch=4,
                       device="cpu").bootstrap(["det", "aux"])
    # canary serves ONLY det; stable serves {det, aux}
    mgr._apply_membership("canary", {"det": 1}, warm=False)
    before = {a: dict(m) for a, m in mgr._active.items()}
    with pytest.raises(LifecycleError, match="would empty"):
        mgr.unload("det")                  # canary would empty -> refuse
    assert {a: dict(m) for a, m in mgr._active.items()} == before
    assert mgr.registry.versions("det") == [1]   # nothing unregistered
    out = mgr.forward({"tokens": np.ones((1, 8), np.int32)})
    assert set(out) == {"aux", "det"}      # stable still serves both


def test_manager_warm_precompiles_buckets(store_with_versions):
    mgr = ModelManager(store_with_versions, max_batch=4, device="cpu")
    example = {"tokens": np.ones((1, 8), np.int32)}
    mgr.bootstrap(["det"], warm_example=example)
    ens = mgr.ensemble_for()
    # every bucket compiled during warm; live traffic compiles nothing new
    buckets = ens.batch_buckets.sizes
    assert set(ens.compile_counts) == set(buckets)
    n_before = ens.num_compilations
    for n in (1, 2, 3, 4):
        mgr.forward({"tokens": np.ones((n, 8), np.int32)})
    assert ens.num_compilations == n_before


# --- GC: keep-last-N retention under serving aliases --------------------------


def test_manager_gc_protects_serving_aliases(tmp_path):
    """GC must never delete a version an alias references: active members,
    rollback targets, and the generation engine's version all survive."""
    store = ModelStore(str(tmp_path))
    _publish_versions(store, "det", 4)
    mgr = ModelManager(store, max_batch=4,
                       device="cpu").bootstrap(["det"])         # active v4
    mgr.load("det", 1)                     # active v1, previous v4
    gen = mgr.attach_generation(GenerationService(num_slots=2))
    try:
        mgr.load_engine("det", 2)          # engine alias holds v2
        res = mgr.gc("det", keep_last_n=1)
        assert res["deleted"] == [3]       # only the unreferenced one
        assert sorted(res["protected"]) == [1, 2, 4]
        assert store.versions("det") == [1, 2, 4]
        assert mgr.stats()["gc_runs"] == 1
    finally:
        gen.close()


# --- generation-engine lifecycle under the manager ----------------------------


def test_manager_engine_requires_generation_service(store_with_versions):
    mgr = _manager(store_with_versions)
    with pytest.raises(LifecycleError, match="no generation service"):
        mgr.load_engine("det")


def test_manager_engine_load_swap_rollback(tmp_path):
    store = ModelStore(str(tmp_path))
    _publish_versions(store, "det", 2)
    mgr = ModelManager(store, max_batch=4,
                       device="cpu").bootstrap(["det"])
    gen = mgr.attach_generation(GenerationService(num_slots=2))
    try:
        res = mgr.load_engine("det")               # latest: v2
        assert res["engine"] == "det@v2" and res["drained"]
        assert res["manifest"]["param_hash"]
        prompt, n = [1, 2, 3], 6
        v2_tokens = gen.generate(
            [prompt], SamplingParams(max_new_tokens=n)).tokens[0]
        # the engine really serves the store version's params: reference
        # engine built from the same restored checkpoint decodes the same
        model = _model()
        params2, _m = store.load("det", 2, model.like())
        ref = InferenceEngine(model, params2, max_len=256, max_batch=8)
        assert v2_tokens == ref.generate([prompt],
                                         max_new_tokens=n).tokens[0]
        res = mgr.load_engine("det", 1)
        assert res["engine"] == "det@v1"
        assert res["previous_engine"] == "det@v2"
        v1_tokens = gen.generate(
            [prompt], SamplingParams(max_new_tokens=n)).tokens[0]
        res = mgr.rollback_engine("det")
        assert res["rolled_back_to"] == 2
        assert gen.generate([prompt],
                            SamplingParams(max_new_tokens=n)
                            ).tokens[0] == v2_tokens
        assert v1_tokens != v2_tokens       # distinct params, distinct decode
        assert mgr.stats()["engine_aliases"] == {"stable": "det@v2"}
        # an engine-held version is load-bearing: unload refuses it even
        # when no ensemble alias serves it any more
        mgr.load("det", 1)                  # ensemble moves off v2...
        with pytest.raises(LifecycleError, match="engine:stable"):
            mgr.unload("det", 2)            # ...but the engine still holds it
    finally:
        gen.close()


# --- admin API over HTTP ------------------------------------------------------


@pytest.fixture()
def lifecycle_server(tmp_path):
    store = ModelStore(str(tmp_path / "store"))
    _publish_versions(store, "det", 2)
    mgr = ModelManager(store, max_batch=4, device="cpu")
    mgr.bootstrap(["det"],
                  warm_example={"tokens": np.ones((1, 8), np.int32)})
    srv = FlexServeServer(FlexServeApp(manager=mgr,
                                       max_wait_ms=5.0)).start()
    yield srv
    srv.stop()


def test_admin_routes(lifecycle_server):
    client = FlexServeClient(*lifecycle_server.address)
    st = client.model_status("det")
    assert st["active"] == {"stable": 2}
    assert [m["version"] for m in st["versions"]] == [1, 2]
    assert all(len(m["param_hash"]) == 64 for m in st["versions"])
    res = client.load_model("det", 1)
    assert res["version"] == 1 and res["previous_version"] == 2
    assert client.model_status("det")["active"] == {"stable": 1}
    res = client.rollback_model("det")
    assert res["rolled_back_to"] == 2
    with pytest.raises(RuntimeError, match="409"):
        client.unload_model("det", 2)          # active -> conflict
    res = client.unload_model("det", 1)
    assert res["unloaded"]
    with pytest.raises(RuntimeError, match="404"):
        client.model_status("ghost")
    with pytest.raises(RuntimeError, match="404"):
        client.load_model("det", 42)
    # registry view carries versions
    models = client.models()["models"]
    assert {(m["name"], m["version"]) for m in models} == {("det", 2)}


def test_admin_requires_manager():
    model, params = smoke_params()
    members = [EnsembleMember(
        "m", lambda p, b, _m=model: _m.forward(p, b)[:, -1, :8], params, 8)]
    app = FlexServeApp(ModelRegistry(), Ensemble(members, max_batch=4))
    srv = FlexServeServer(app).start()
    try:
        client = FlexServeClient(*srv.address)
        with pytest.raises(RuntimeError, match="503"):
            client.load_model("m", 1)
        with pytest.raises(RuntimeError, match="400"):
            client.infer({"tokens": [[1, 2, 3, 4]]}, target="canary")
    finally:
        srv.stop()


def test_per_request_alias_targeting(lifecycle_server):
    client = FlexServeClient(*lifecycle_server.address)
    client.load_model("det", 1, alias="canary")
    tokens = [[3, 1, 4, 1, 5, 9, 2, 6]]
    stable = client.infer({"tokens": tokens})
    canary = client.infer({"tokens": tokens}, target="canary")
    # different versions may classify differently; both must answer
    assert stable["policy"] == canary["policy"] == "soft_vote"
    with pytest.raises(RuntimeError, match="404"):
        client.infer({"tokens": tokens}, target="ghost")
    st = client.model_status("det")
    assert st["active"] == {"stable": 2, "canary": 1}


def test_engine_admin_routes(lifecycle_server):
    client = FlexServeClient(*lifecycle_server.address)
    assert client.engines() == {"aliases": {}, "ready": False}
    with pytest.raises(RuntimeError, match="409"):
        client.load_engine("ghost")            # no published versions
    res = client.load_engine("det", 1)
    assert res["engine"] == "det@v1" and res["alias"] == "stable"
    assert client.engines() == {"aliases": {"stable": "det@v1"},
                                "ready": True}
    # canary engine takes per-request "target" traffic next to stable
    client.load_engine("det", 2, alias="canary")
    stable = client.generate([[1, 2, 3]], max_new_tokens=4)
    canary = client.generate([[1, 2, 3]], max_new_tokens=4, target="canary")
    assert len(stable["outputs"][0]) == len(canary["outputs"][0]) == 4
    with pytest.raises(RuntimeError, match="404"):
        client.generate([[1, 2, 3]], max_new_tokens=4, target="ghost")
    # streaming reports which engine served it
    done = list(client.generate_stream([1, 2, 3], max_new_tokens=4,
                                       target="canary"))[-1]
    assert done["engine"] == "det@v2"
    # swap stable and roll it back
    res = client.load_engine("det", 2)
    assert res["previous_engine"] == "det@v1"
    res = client.rollback_engine("det")
    assert res["rolled_back_to"] == 1 and res["engine"] == "det@v1"
    with pytest.raises(RuntimeError, match="409"):
        client.rollback_engine("other-name")
    st = client.model_status("det")
    assert st["engine_active"] == {"stable": 1, "canary": 2}
    m = client.metrics()
    assert m["lifecycle"]["engine_loads"] >= 3
    assert m["lifecycle"]["engine_rollbacks"] == 1
    assert m["generate"]["engines"]["stable"]["engine"] == "det@v1"


def test_gc_admin_route(lifecycle_server):
    client = FlexServeClient(*lifecycle_server.address)
    with pytest.raises(RuntimeError, match="400"):
        client.gc_model("det", keep_last_n=0)
    res = client.gc_model("det", keep_last_n=1)
    assert res["deleted"] == [1]               # v2 active in "stable"
    assert res["kept"] == [2] and res["protected"] == [2]
    st = client.model_status("det")
    assert [m["version"] for m in st["versions"]] == [2]
    with pytest.raises(RuntimeError, match="404"):
        client.gc_model("ghost", keep_last_n=1)


# --- healthz readiness --------------------------------------------------------


def test_healthz_readiness_transitions():
    app = FlexServeApp()                       # nothing deployed
    srv = FlexServeServer(app)
    srv.start(wait_ready=False)
    try:
        client = FlexServeClient(*srv.address)
        with pytest.raises(RuntimeError, match="503"):
            client.healthz()
        assert client.health()["status"] == "ok"   # liveness stays green
        model, params = smoke_params()
        app.registry.register("m", model, params)
        assert client.healthz()["status"] == "ready"
        app._closing = True
        with pytest.raises(RuntimeError, match="503"):
            client.healthz()
    finally:
        srv.stop()


def test_server_start_waits_for_readiness(lifecycle_server):
    """start() (used by every fixture here) returns only once /healthz is
    200 — probe it straight away."""
    client = FlexServeClient(*lifecycle_server.address)
    assert client.healthz()["status"] == "ready"
    assert client.healthz()["coalescing"]


# --- THE scenario: hot swap under open-loop traffic ---------------------------


def test_hot_swap_under_open_loop_traffic(lifecycle_server):
    """Load new version -> warm -> swap -> retire old, while an open-loop
    client fires /v1/infer on a fixed cadence.  Zero failed requests; the
    active manifest is visible before and after the swap."""
    host, port = lifecycle_server.address
    client = FlexServeClient(host, port)

    st = client.model_status("det")
    assert st["active"]["stable"] == 2
    hash_before = st["versions"][1]["param_hash"]

    results = {"ok": [], "failed": []}
    stop = threading.Event()
    pool = concurrent.futures.ThreadPoolExecutor(8)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(1, 100, (1, 8)).tolist() for _ in range(16)]

    def one_request(i):
        try:
            resp = FlexServeClient(host, port).infer(
                {"tokens": payloads[i % len(payloads)]})
            assert len(resp["ensemble"]) == 1
            results["ok"].append(i)            # list append: thread-safe
        except Exception as e:                 # noqa: BLE001 — we count them
            results["failed"].append(repr(e))

    def open_loop():
        """Fixed arrival cadence, independent of completions (open loop)."""
        i = 0
        while not stop.is_set():
            pool.submit(one_request, i)
            i += 1
            time.sleep(0.02)

    driver = threading.Thread(target=open_loop)
    driver.start()
    try:
        time.sleep(0.3)                        # traffic flowing on v2
        res = client.load_model("det", 1, warm=True)   # load+warm+swap
        assert res["drained"], "old state must drain before retirement"
        assert client.model_status("det")["active"]["stable"] == 1
        res = client.unload_model("det", 2)    # retire the old version
        assert res["unloaded"]
        time.sleep(0.3)                        # traffic flowing on v1
    finally:
        stop.set()
        driver.join(timeout=5)
        pool.shutdown(wait=True)

    assert results["failed"] == []             # ZERO failed requests
    assert len(results["ok"]) >= 20            # the loop really ran
    st = client.model_status("det")
    assert st["active"]["stable"] == 1
    hash_after = next(m["param_hash"] for m in st["versions"]
                      if m["version"] == 1)
    assert hash_after != hash_before           # provenance moved with swap
    assert st["traffic"]["det@v1"]["rows"] >= 1
    assert st["traffic"]["det@v2"]["rows"] >= 1
    m = client.metrics()["lifecycle"]
    assert m["loads"] >= 1 and m["unloads"] >= 1 and m["swaps"] >= 1
    assert m["last_warm_ms"] >= 0.0


# --- THE streaming scenario: engine hot swap under open-loop streams ----------


def test_engine_hot_swap_zero_dropped_streams(lifecycle_server):
    """An open-loop pool of streaming /v1/generate clients runs while the
    admin API hot-swaps the generation engine v1 -> v2 and rolls it back.
    ZERO streams fail or truncate: streams in flight at swap time drain on
    the engine that admitted them, later streams decode on the new one."""
    host, port = lifecycle_server.address
    admin = FlexServeClient(host, port)
    admin.load_engine("det", 1)

    n_tokens = 6
    results = {"ok": [], "failed": []}
    engines_seen = set()
    stop = threading.Event()
    pool = concurrent.futures.ThreadPoolExecutor(6)

    def one_stream(i):
        cl = FlexServeClient(host, port)
        try:
            events = list(cl.generate_stream(
                [1 + i % 7, 2, 3], max_new_tokens=n_tokens,
                temperature=0.6, seed=i))
            done = events[-1]
            assert done["event"] == "done", done
            assert done["token_count"] == n_tokens, done   # not truncated
            assert [e["token"] for e in events[:-1]] == done["tokens"]
            engines_seen.add(done["engine"])   # set.add: thread-safe
            results["ok"].append(i)
        except Exception as e:                 # noqa: BLE001 — we count them
            results["failed"].append(repr(e))
        finally:
            cl.close()

    def open_loop():
        i = 0
        while not stop.is_set():
            pool.submit(one_stream, i)
            i += 1
            time.sleep(0.02)

    driver = threading.Thread(target=open_loop)
    driver.start()
    try:
        time.sleep(0.4)                        # streams flowing on v1
        res = admin.load_engine("det", 2)      # hot swap under live decode
        assert res["drained"], "in-flight streams must drain on old engine"
        time.sleep(0.4)                        # streams flowing on v2
        res = admin.rollback_engine("det")     # and back again, still live
        assert res["rolled_back_to"] == 1
        time.sleep(0.3)
    finally:
        stop.set()
        driver.join(timeout=5)
        pool.shutdown(wait=True)

    assert results["failed"] == []             # ZERO failed/truncated streams
    assert len(results["ok"]) >= 20
    assert {"det@v1", "det@v2"} <= engines_seen   # both versions served
    g = admin.metrics()["generate"]
    assert g["streams"]["failed"] == 0 and g["streams"]["cancelled"] == 0
    assert g["engine_swaps"] >= 3
    assert g["streams"]["completed"] >= len(results["ok"])


# --- the port's own ----------------------------------------------------------


def test_default_factory_reads_the_manifest():
    model, apply, c = default_factory({"config": ARCH, "num_classes": 5,
                                       "num_layers": 1})
    assert c == 5 and model.config.num_layers == 1
    assert model.config.d_model == reduce_for_smoke(
        get_config(ARCH)).d_model
    full, _, c = default_factory({"config": ARCH, "reduced": False,
                                  "num_layers": 8})
    assert c == 16
    assert (full.config.d_model, full.config.num_layers) == (4096, 8)
    like = full.like()                     # 3.8 GB of shapes, no storage
    assert all(v.device.type == "meta" for v in like.values())
    out = apply(model.init(0, "cpu"),
                {"tokens": torch.ones((2, 4), dtype=torch.int32)})
    assert tuple(out.shape) == (2, 5)


def test_unload_releases_the_versions_tensors(store_with_versions):
    mgr = _manager(store_with_versions)                # serves v2
    mgr.load("det", 1, alias="canary")
    probe = weakref.ref(mgr.registry.get("det", 1).params["embed"])
    ledger = mgr.memory_ledger(hbm_per_chip=2**34)
    assert {e.name for e in ledger.entries} == {"det@v1", "det@v2"}
    mgr.load("det", 2, alias="canary")                 # canary off v1
    mgr.unload("det", 1)
    # freed at once, not at the next cyclic collection: no reference cycle
    # holds a retired ensemble state's params
    assert probe() is None
    ledger = mgr.memory_ledger(hbm_per_chip=2**34)
    assert [e.name for e in ledger.entries] == ["det@v2"]


def _pair_store(store_cls, root, init):
    """``det`` v1, v2 and a 1-layer ``det#draft`` v1, v2 (the draft's depth
    in its manifest), params from ``init(model, seed)``."""
    import dataclasses
    store = store_cls(str(root))
    cfg = reduce_for_smoke(get_config(ARCH))
    for name, layers in (("det", None), ("det#draft", 1)):
        for seed in range(2):
            meta = {"reduced": True, "num_classes": 8, "max_len": 64,
                    "max_batch": 4}
            if layers:
                meta["num_layers"] = layers
            store.publish(name, init(dataclasses.replace(
                cfg, num_layers=layers or cfg.num_layers), seed + (
                    100 if layers else 0)), config=ARCH, source=cfg.source,
                meta=meta)
    return store


def _pair_sequence(mgr, gen):
    """load the pair, load a canary pair, promote it, gc the draft, roll
    back, demote: the decisions each step returns."""
    keys = ("name", "version", "speculative", "draft", "alias", "engine",
            "previous_engine", "drained")
    out = []

    def pick(res, extra=()):
        return {k: res.get(k) for k in keys + tuple(extra)}

    out.append(pick(mgr.load_engine("det", 1, draft="det#draft",
                                    warm=False)))
    out.append(pick(mgr.load_engine("det", 2, alias="canary",
                                    draft="det#draft", draft_version=1,
                                    warm=False)))
    out.append(pick(mgr.promote_engine("canary"), ("promoted",)))
    out.append(dict(mgr.stats()["engine_drafts"]))
    gc = mgr.gc("det#draft", keep_last_n=1)
    out.append((sorted(gc["deleted"]), sorted(gc["protected"])))
    out.append(pick(mgr.rollback_engine(warm=False), ("rolled_back_to",)))
    out.append(dict(mgr.stats()["engine_drafts"]))
    out.append(pick(mgr.demote_engine("canary")))
    out.append(dict(mgr.stats()["engine_drafts"]))
    out.append(type(gen.engine_for()).__name__)
    return out


def test_speculative_pair_lifecycle_matches_jax(tmp_path):
    """The engine plane's speculative pair on both packages over stores of
    the same shape: load, canary, promote, gc (both drafts protected),
    rollback and demote take the same decisions, the pair moves as one
    unit, and a stream on the rolled-back pair reports its speculation."""
    from repro.core import SamplingParams as JSamp
    from repro.models.build import build_model as jbuild
    from repro.serving import GenerationService as JGen
    from repro.serving import ModelManager as JManager
    jstore = _pair_store(JStore, tmp_path / "jax",
                         lambda cfg, seed: jbuild(cfg).init(
                             jax.random.PRNGKey(seed)))
    tstore = _pair_store(ModelStore, tmp_path / "torch",
                         lambda cfg, seed: build_model(cfg).init(seed,
                                                                 "cpu"))
    got = []
    for mgr, gen, samp in (
            (JManager(jstore, max_batch=4), JGen(num_slots=2), JSamp),
            (ModelManager(tstore, max_batch=4, device="cpu"),
             GenerationService(num_slots=2), SamplingParams)):
        mgr.attach_generation(gen)
        try:
            seq = _pair_sequence(mgr, gen)
            done = list(gen.stream([1, 2, 3], samp(
                max_new_tokens=8)).events())[-1]
            seq.append((done["event"], done["token_count"],
                        done["speculation"]["proposed"] > 0))
            got.append(seq)
        finally:
            gen.close()
    assert got[1] == got[0]
    assert got[1][0]["speculative"] and got[1][0]["draft"] == "det#draft@v2"
    assert got[1][3] == {"stable": "det#draft@v1", "canary": "det#draft@v1"}
    assert got[1][4] == ([], [1, 2])           # both drafts protected
    assert got[1][6]["stable"] == "det#draft@v2"


def test_speculative_pair_refuses_an_incompatible_draft(store_with_versions):
    """A pair that cannot be built (a window below 2) is refused before
    the alias flips, with the pair's message, as ``LifecycleError``."""
    mgr = _manager(store_with_versions)
    gen = mgr.attach_generation(GenerationService(num_slots=2))
    try:
        with pytest.raises(LifecycleError, match="incompatible speculative "
                                                 "pair det v2 \\+ det v1"):
            mgr.load_engine(
                "det", draft="det", draft_version=1, warm=False,
                max_window=1)
        assert not gen.ready                           # nothing installed
        assert mgr.stats()["engine_drafts"] == {}
    finally:
        gen.close()


def test_checkpoint_load_fault_refuses_before_publishing(tmp_path):
    from repro_torch.core import FaultInjector
    store = ModelStore(str(tmp_path))
    _publish_versions(store, "det", 2)
    faults = FaultInjector.load({"faults": [{"site": "checkpoint_load",
                                             "at": 2}]})
    mgr = ModelManager(store, max_batch=4, device="cpu", faults=faults)
    mgr.bootstrap(["det"])                             # hit 1: fine
    with pytest.raises(LifecycleError, match="checkpoint load failed"):
        mgr.load("det", 1)                             # hit 2: fires
    assert mgr.stats()["aliases"] == {"stable": {"det": 2}}
    assert mgr.registry.versions("det") == [2]


def test_store_launcher_flags_reach_build_store_app(monkeypatch):
    seen = {}

    def fake(names, store_dir, **kw):
        seen.update(kw, names=names, store_dir=store_dir)
        raise KeyboardInterrupt

    monkeypatch.setattr(serve, "build_store_app", fake)
    with pytest.raises(KeyboardInterrupt):
        serve.main(["--ensemble", "yi-9b", "yi-9b", "--device", "cpu",
                    "--model-store", "/store", "--no-trace",
                    "--flight-recorder-size", "7", "--profile-dir", "/p",
                    "--slo-config", "slo.json"])
    assert seen["names"] == ["yi-9b", "yi-9b"]
    assert seen["store_dir"] == "/store"
    assert (seen["trace"], seen["flight_recorder_size"],
            seen["profile_dir"], seen["slo_config"]) == \
        (False, 7, "/p", "slo.json")


def test_build_store_app_seeds_then_reuses_the_store(tmp_path):
    kw = dict(device="cpu", num_classes=4, max_batch=2, num_slots=2)
    app = serve.build_store_app(["yi-9b"], str(tmp_path), **kw)
    try:
        st = app.manager.status("yi-9b#0")
        assert [m["version"] for m in st["versions"]] == [1]
        assert st["versions"][0]["reduced"] is True
        assert st["engine_active"] == {"stable": 1}
        h = st["versions"][0]["param_hash"]
    finally:
        app.close()
    app = serve.build_store_app(["yi-9b"], str(tmp_path), **kw)
    try:
        st = app.manager.status("yi-9b#0")
        assert [m["param_hash"] for m in st["versions"]] == [h]
    finally:
        app.close()


# --- the slice as a whole: one store, both packages --------------------------


def _probs(app, tokens):
    logits = app.manager.forward({"tokens": np.asarray(tokens, np.int32)})
    out = {}
    for name, v in logits.items():
        v = (v.double().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v, np.float64))
        e = np.exp(v - v.max(-1, keepdims=True))
        out[name] = e / e.sum(-1, keepdims=True)
    return out


SLICE_TOKENS = [[3, 1, 4, 1, 5, 9, 2, 6], [27, 18, 28, 18, 28, 45, 90, 45]]


def test_jax_and_port_apps_over_one_store(tmp_path):
    cfg, jmodel, _ = smoke_model(ARCH)
    jstore = JStore(str(tmp_path))
    for i in range(2):
        jstore.publish(f"{ARCH}#{i}", jmodel.init(jax.random.PRNGKey(i)),
                       config=ARCH, source=cfg.source,
                       meta={"reduced": True, "num_classes": 8})
    kw = dict(max_batch=4, num_slots=2)
    japp = jserve.build_store_app([ARCH, ARCH], str(tmp_path), **kw)
    tapp = serve.build_store_app([ARCH, ARCH], str(tmp_path), device="cpu",
                                 **kw)
    jsrv, tsrv = JServer(japp).start(), FlexServeServer(tapp).start()
    jc, tc = JClient(*jsrv.address), FlexServeClient(*tsrv.address)
    try:
        steps = [("infer", None)]
        jstore.publish(f"{ARCH}#0", jmodel.init(jax.random.PRNGKey(7)),
                       config=ARCH, meta={"reduced": True,
                                          "num_classes": 8})
        steps += [("load", 2), ("infer", None), ("rollback", None),
                  ("infer", None)]
        n = 0
        for action, arg in steps:
            if action == "load":
                assert jc.load_model(f"{ARCH}#0", arg)["version"] == \
                    tc.load_model(f"{ARCH}#0", arg)["version"] == 2
                continue
            if action == "rollback":
                assert jc.rollback_model(f"{ARCH}#0")["rolled_back_to"] \
                    == tc.rollback_model(f"{ARCH}#0")["rolled_back_to"] \
                    == 1
                continue
            n += 1
            tid = f"slice-{n}"
            want = jc.infer({"tokens": SLICE_TOKENS}, trace_id=tid)
            got = tc.infer({"tokens": SLICE_TOKENS}, trace_id=tid)
            assert got == want
            assert tc.trace(tid)["attrs"] == jc.trace(tid)["attrs"]
            jp, tp = _probs(japp, SLICE_TOKENS), _probs(tapp, SLICE_TOKENS)
            assert set(jp) == set(tp)
            for name in jp:
                np.testing.assert_allclose(tp[name], jp[name], atol=1e-4)
                top = np.sort(jp[name], -1)     # decisions far from ties
                assert ((top[:, -1] - top[:, -2]) > 1e-3).all()
        assert tc.trace("slice-2")["attrs"]["version"] == \
            f"{ARCH}#0@v2,{ARCH}#1@v1"
        assert tc.model_status(f"{ARCH}#0")["active"] == \
            jc.model_status(f"{ARCH}#0")["active"] == {"stable": 1}
    finally:
        jc.close()
        tc.close()
        jsrv.stop()
        tsrv.stop()
