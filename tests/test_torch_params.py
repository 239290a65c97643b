"""Weight carry-over between the packages, and the port's independence
from JAX: ``repro_torch`` and ``chip_smoke.py`` import none of ``jax``,
``msgpack``, ``ml_dtypes`` and ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.training.checkpoint import _flatten
from repro_torch.params import flatten, from_jax, to_flat, unflatten


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


ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch,dtype", [("yi-9b", "float32"),
                                        ("command-r-plus-104b", "bfloat16"),
                                        ("rwkv6-1.6b", "bfloat16"),
                                        ("zamba2-2.7b", "float32"),
                                        ("qwen3-moe-235b-a22b", "bfloat16"),
                                        ("deepseek-v3-671b", "float32"),
                                        ("llama-3.2-vision-11b", "bfloat16"),
                                        ("whisper-base", "float32")])
def test_from_jax_to_flat_round_trip(arch, dtype):
    import dataclasses
    cfg = dataclasses.replace(jreduce(jget_config(arch)), dtype=dtype)
    flat = _flatten(jbuild_model(cfg).init(jax.random.PRNGKey(0)))
    params = from_jax(flat, "cpu")
    assert set(params) == set(flat)
    back = to_flat(params)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)


def test_from_jax_casts_and_places():
    _, _, jp = smoke_model("yi-9b")
    params = from_jax(_flatten(jp), "cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in params.values())
    assert all(t.device.type == "cpu" for t in params.values())


def test_flatten_unflatten_inverse():
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert flatten(tree) == {"a/b": 1, "a/c/d": 2, "e": 3}
    assert unflatten(flatten(tree)) == tree


def test_import_guard_no_jax_no_repro():
    code = ("import sys, repro_torch.launch.serve, repro_torch.serving.server,"
            " repro_torch.kernels.flash_attention.ops,"
            " repro_torch.kernels.decode_attention.ops,"
            " repro_torch.core.engine, repro_torch.core.scheduler,"
            " repro_torch.core.kv_pager, repro_torch.models.paged,"
            " repro_torch.models.moe,"
            " repro_torch.models.rwkv6, repro_torch.models.hybrid,"
            " repro_torch.kernels.rwkv6_wkv.ops,"
            " repro_torch.kernels.mamba2_ssd.ops, repro_torch.core.faults,"
            " repro_torch.serving.generate, repro_torch.serving.replica,"
            " repro_torch.serving.client, repro_torch.serving.lifecycle,"
            " repro_torch.serving.modelstore, repro_torch.serving.telemetry,"
            " repro_torch.training.checkpoint, repro_torch.core.slo,"
            " repro_torch.training.data, repro_torch.training.optimizer,"
            " repro_torch.training.train_loop, repro_torch.launch.train,"
            " repro_torch.opt, repro_torch.sharding,"
            " repro_torch.launch.mesh, repro_torch.launch.shardings,"
            " repro_torch.launch.dryrun, repro_torch.analysis.costs,"
            " repro_torch.analysis.roofline,"
            " repro_torch.analysis.perf_compare;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'msgpack', 'ml_dtypes'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_source_scan_no_jax_no_repro_imports():
    pattern = re.compile(r"^\s*(import\s+(jax|msgpack|ml_dtypes)\b|"
                         r"from\s+(jax|msgpack|ml_dtypes)\b|"
                         r"from\s+repro\.|import\s+repro\.|"
                         r"from\s+repro\s+import|import\s+repro\s*$)",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20 and ROOT / "src" / "repro_torch" / "opt.py" in files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
