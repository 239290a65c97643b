"""The port's checkpoint format against the JAX package's, on the CPU.

Files go both ways: a JAX ``checkpoint.save`` file (zstd-compressed here,
where ``zstandard`` imports) and an uncompressed file packed in the test
with ``msgpack.packb`` are read by the port; a port-written file is read
by JAX ``checkpoint.load``.  bf16, fp32 and int32 leaves must come back
equal, ``param_hash`` must be equal across the packages for the same
reduced yi-9b weights, and the port's msgpack subset must write exactly
what ``msgpack.packb(..., use_bin_type=True)`` writes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.training import checkpoint as jck
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.build import build_model
from repro_torch.params import from_jax, to_flat
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


def _leaves(seed=0):
    """bf16, fp32 and int32 leaves (numpy, the JAX package's dtypes),
    from a numpy generator."""
    rng = np.random.default_rng(seed)
    return {
        "embed": jnp.asarray(rng.normal(size=(7, 5)), jnp.bfloat16),
        "layers/attn/wq": rng.normal(size=(2, 5, 3)).astype(np.float32),
        "layers/ids": rng.integers(-9, 9, (2, 4)).astype(np.int32),
        "scalar": np.float32(1.25),
    }


def _jax_tree(seed=0):
    flat = {k: np.asarray(v) for k, v in _leaves(seed).items()}
    return {"embed": flat["embed"], "scalar": flat["scalar"],
            "layers": {"attn": {"wq": flat["layers/attn/wq"]},
                       "ids": flat["layers/ids"]}}


def _assert_equal_to_jax(tensors, want):
    got = to_flat(tensors)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)


def test_reads_a_jax_zstd_checkpoint(tmp_path):
    assert ck.zstandard is not None         # the JAX writer compresses here
    tree = _jax_tree()
    path = jck.save(str(tmp_path / "step_3.ckpt"), tree, step=3,
                    meta={"config": "yi-9b"})
    assert open(path, "rb").read(4) == b"\x28\xb5\x2f\xfd"
    leaves, meta = ck.load(path)
    assert meta == {"config": "yi-9b", "step": 3}
    assert leaves["embed"].dtype == torch.bfloat16
    _assert_equal_to_jax(leaves, _flatten(tree))


def test_reads_an_uncompressed_msgpack_checkpoint(tmp_path):
    flat = _flatten(_jax_tree(1))
    payload = {"meta": {"step": 0, "note": "hand-packed", "ok": True,
                        "none": None, "ratio": 0.5, "list": [1, -2]},
               "leaves": {k: {"dtype": str(np.asarray(v).dtype),
                              "shape": list(np.shape(v)),
                              "data": np.asarray(v).tobytes()}
                          for k, v in flat.items()}}
    path = tmp_path / "step_0.ckpt"
    path.write_bytes(msgpack.packb(payload, use_bin_type=True))
    leaves, meta = ck.load(str(path))
    assert meta == payload["meta"]
    _assert_equal_to_jax(leaves, flat)


def test_jax_reads_a_port_checkpoint(tmp_path):
    want = _flatten(_jax_tree(2))
    params = from_jax(want, "cpu")
    path = ck.save(str(tmp_path / "step_0.ckpt"), params,
                   meta={"source": "port"})
    leaves, meta = jck.load(path)
    assert meta == {"source": "port", "step": 0}
    assert set(leaves) == set(want)
    for k, v in want.items():
        assert leaves[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(leaves[k], np.asarray(v))
    # and the port reads its own file back
    _assert_equal_to_jax(ck.load(path)[0], want)


def test_port_file_is_the_msgpack_payload_byte_for_byte(tmp_path):
    params = from_jax(_flatten(_jax_tree(3)), "cpu")
    path = ck.save(str(tmp_path / "x.ckpt"), params, step=5,
                   meta={"a": 1})
    payload = {"meta": {"a": 1, "step": 5},
               "leaves": {k: {"dtype": ck.dtype_name(params[k]),
                              "shape": list(params[k].shape),
                              "data": ck.host_array(params[k]).tobytes()}
                          for k in sorted(params)}}
    assert open(path, "rb").read() == msgpack.packb(payload,
                                                    use_bin_type=True)


@pytest.mark.parametrize("arch,dtype", [("yi-9b", "float32"),
                                        ("yi-9b", "bfloat16"),
                                        ("rwkv6-1.6b", "bfloat16")])
def test_param_hash_equals_the_jax_package(arch, dtype):
    cfg = dataclasses.replace(jreduce(jget_config(arch)), dtype=dtype)
    tree = jbuild_model(cfg).init(jax.random.PRNGKey(0))
    params = from_jax(_flatten(tree), "cpu")
    assert ck.param_hash(params) == jck.param_hash(tree)


def test_save_and_hash_returns_param_hash(tmp_path):
    params = from_jax(_flatten(_jax_tree(4)), "cpu")
    digest = ck.save_and_hash(str(tmp_path / "x.ckpt"), params)
    assert digest == ck.param_hash(params) == jck.param_hash(_jax_tree(4))


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1,
    -2**63, 0.5, -1e300, "", "a" * 31, "a" * 32, "a" * 256, "é" * 40000,
    b"", b"x" * 300, [1, [2, [3]]], list(range(20)), {"k": {"n": 1}},
    {str(i): i for i in range(20)}])
def test_packb_is_msgpack(value):
    data = msgpack.packb(value, use_bin_type=True)
    assert ck.packb(value) == data
    assert ck.unpackb(data) == msgpack.unpackb(data, raw=False)


def test_zstd_is_refused_without_zstandard(tmp_path, monkeypatch):
    path = jck.save(str(tmp_path / "z.ckpt"), _jax_tree())
    monkeypatch.setattr(ck, "zstandard", None)
    with pytest.raises(ck.CheckpointError, match="zstandard"):
        ck.load(path)


def test_oversize_leaf_is_refused_before_writing(tmp_path):
    """yi-9b's stacked w_gate at 48 layers is 4,328,521,728 bytes: over
    msgpack's bin 32 limit, as the JAX packer says.  A meta tensor carries
    the shape without allocating it."""
    big = torch.empty((48, 4096, 11008), dtype=torch.bfloat16, device="meta")
    assert big.numel() * big.element_size() == 4_328_521_728 > ck.MAX_BIN_BYTES
    path = tmp_path / "big.ckpt"
    with pytest.raises(ck.CheckpointError, match="bin 32"):
        ck.save(str(path), {"small": torch.zeros(2), "layers/mlp/w_gate": big})
    assert not os.listdir(tmp_path)         # nothing written, not even tmp
    with pytest.raises(ck.CheckpointError, match="bin 32"):
        ck._bin_header(ck.MAX_BIN_BYTES + 1)
    assert ck._bin_header(ck.MAX_BIN_BYTES) == b"\xc6\xff\xff\xff\xff"


def test_yi9b_full_depth_cannot_be_written_but_eight_layers_can():
    """The phase-8 depth cut: full-width yi-9b at 48 layers has a leaf
    over the limit; at 8 layers every leaf fits (shapes only, on meta)."""
    cfg = get_config("yi-9b")
    full = build_model(cfg).like()
    cut = build_model(dataclasses.replace(cfg, num_layers=8)).like()

    def biggest(p):
        return max(v.numel() * v.element_size() for v in p.values())
    assert biggest(full) > ck.MAX_BIN_BYTES >= biggest(cut)
    assert sum(v.numel() * v.element_size() for v in cut.values()) \
        == 3_817_095_168


def test_truncated_and_foreign_files_are_refused(tmp_path):
    path = ck.save(str(tmp_path / "t.ckpt"),
                   from_jax(_flatten(_jax_tree()), "cpu"))
    data = open(path, "rb").read()
    (tmp_path / "cut.ckpt").write_bytes(data[:len(data) // 2])
    with pytest.raises(ck.CheckpointError, match="truncated"):
        ck.load(str(tmp_path / "cut.ckpt"))
    (tmp_path / "other.ckpt").write_bytes(msgpack.packb([1, 2, 3]))
    with pytest.raises(ck.CheckpointError, match="not a checkpoint"):
        ck.load(str(tmp_path / "other.ckpt"))


def test_restore_checks_keys_and_shapes(tmp_path):
    model = build_model(reduce_for_smoke(get_config("yi-9b")))
    params = model.init(1, "cpu")
    path = ck.save(str(tmp_path / "m.ckpt"), params)
    got, meta = ck.restore(path, model.like())
    assert meta == {"step": 0}
    for k, v in params.items():
        assert torch.equal(got[k], v), k
    bad = dict(model.like())
    bad["embed"] = torch.empty((3, 3), device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(path, bad)
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(path, {"nope": torch.empty(1, device="meta")})


def test_manifest_round_trip_and_latest(tmp_path):
    m = {"name": "yi-9b#0", "version": 3, "param_hash": "ab" * 32}
    path = ck.write_manifest(str(tmp_path / "v" / "manifest.json"), m)
    assert ck.read_manifest(path) == m == jck.read_manifest(path)
    assert not os.path.exists(path + ".tmp")
    assert ck.latest(str(tmp_path / "none")) is None
    for step in (2, 10, 9):
        ck.save(str(tmp_path / f"step_{step}.ckpt"), {"x": torch.zeros(1)})
    assert ck.latest(str(tmp_path)) == str(tmp_path / "step_10.ckpt") \
        == jck.latest(str(tmp_path))
