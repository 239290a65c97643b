"""The port's versioned model store, and stores shared with the JAX package.

The contracts of the store half of ``tests/test_lifecycle.py`` (publish
and manifests, hash-verified loads, append-only versions, keep-last-N
retention), and stores written by either package loaded and hash-verified
by the other on the same reduced yi-9b weights.
"""

import os

import jax
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.serving import ModelStore as JStore
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.build import build_model
from repro_torch.params import from_jax, to_flat
from repro_torch.serving import ModelStore, StoreError
from repro_torch.training import checkpoint


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


def test_store_publish_and_manifest(tmp_path):
    store = ModelStore(str(tmp_path))
    _publish_versions(store, "det", 2)
    assert store.versions("det") == [1, 2]
    assert store.latest_version("det") == 2
    m = store.manifest("det", 1)
    assert m["name"] == "det" and m["version"] == 1
    assert m["config"] == ARCH
    assert len(m["param_hash"]) == 64          # sha256 hex
    assert m["source"] and m["created_at"]
    assert m["reduced"] is True and m["num_classes"] == 8
    # distinct params -> distinct provenance
    assert m["param_hash"] != store.manifest("det", 2)["param_hash"]
    with pytest.raises(StoreError, match="no published version"):
        store.manifest("det", 9)
    with pytest.raises(StoreError, match="invalid model name"):
        store.model_dir("../escape")


def test_store_load_verifies_param_hash(tmp_path):
    store = ModelStore(str(tmp_path))
    model = _publish_versions(store, "det", 1)
    params, manifest = store.load("det", 1, model.like())
    assert manifest["param_hash"] == checkpoint.param_hash(params)
    for k, v in model.init(0, "cpu").items():
        assert torch.equal(params[k], v), k
    # corrupt the checkpoint: provenance verification must refuse it
    checkpoint.save(os.path.join(store.version_dir("det", 1), "step_0.ckpt"),
                    model.init(99, "cpu"))
    with pytest.raises(StoreError, match="param hash mismatch"):
        store.load("det", 1, model.like())
    # verify=False is the only way past it
    store.load("det", 1, model.like(), verify=False)


def test_store_versions_are_append_only(tmp_path):
    store = ModelStore(str(tmp_path))
    _publish_versions(store, "det", 1)
    v = store.publish("det", _model().init(5, "cpu"), config=ARCH)
    assert v == 2
    assert store.names() == ["det"]
    # a crashed publish (directory claimed, no manifest) is not a version
    os.mkdir(store.version_dir("det", 3))
    assert store.versions("det") == [1, 2]
    assert store.publish("det", _model().init(6, "cpu"), config=ARCH) == 4


def test_store_gc_keep_last_n(tmp_path):
    store = ModelStore(str(tmp_path))
    _publish_versions(store, "det", 5)
    res = store.gc("det", 2, protected={1})
    assert res["deleted"] == [2, 3]            # 4, 5 newest; 1 protected
    assert res["kept"] == [1, 4, 5]
    assert store.versions("det") == [1, 4, 5]
    # version numbers are never reused after GC
    assert store.publish("det", _model().init(9, "cpu"), config=ARCH) == 6
    with pytest.raises(StoreError, match="keep_last_n"):
        store.gc("det", 0)
    with pytest.raises(StoreError, match="no published versions"):
        store.gc("ghost", 1)


def test_store_load_places_on_device(tmp_path):
    store = ModelStore(str(tmp_path))
    model = _publish_versions(store, "det", 1)
    params, _ = store.load("det", 1, model.like(), device="cpu")
    assert all(v.device.type == "cpu" for v in params.values())
    assert {k: v.dtype for k, v in params.items()} == \
        {k: v.dtype for k, v in model.like().items()}


# --- stores shared with the JAX package ----------------------------------


@pytest.mark.parametrize("n", [1, 2])
def test_port_loads_and_verifies_a_jax_store(tmp_path, n):
    cfg, jmodel, _ = smoke_model(ARCH)
    jstore = JStore(str(tmp_path))
    trees = []
    for seed in range(n):
        trees.append(jmodel.init(jax.random.PRNGKey(seed)))
        jstore.publish("det", trees[-1], config=ARCH, source=cfg.source,
                       meta={"reduced": True, "num_classes": 8})
    store = ModelStore(str(tmp_path))
    assert store.versions("det") == list(range(1, n + 1))
    for v, tree in enumerate(trees, 1):
        params, manifest = store.load("det", v, _model().like())
        assert manifest == jstore.manifest("det", v)
        got = to_flat(params)
        for k, want in _flatten(tree).items():
            np.testing.assert_array_equal(got[k], np.asarray(want))


def test_jax_loads_and_verifies_a_port_store(tmp_path):
    cfg, jmodel, _ = smoke_model(ARCH)
    trees = [jmodel.init(jax.random.PRNGKey(s)) for s in (3, 4)]
    store = ModelStore(str(tmp_path))
    for tree in trees:
        store.publish("det", from_jax(_flatten(tree), "cpu"), config=ARCH,
                      meta={"reduced": True})
    jstore = JStore(str(tmp_path))
    like = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    for v, tree in enumerate(trees, 1):
        got, manifest = jstore.load("det", v, like)   # re-hashes
        assert manifest == store.manifest("det", v)
        for k, want in _flatten(tree).items():
            np.testing.assert_array_equal(np.asarray(_flatten(got)[k]),
                                          np.asarray(want))
    # one store, both publishers: numbers keep counting up
    assert jstore.publish("det", trees[0], config=ARCH) == 3
    assert store.versions("det") == [1, 2, 3]
    store.load("det", 3, _model().like())
