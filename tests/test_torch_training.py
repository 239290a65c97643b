"""The port's training loop against the JAX package's, on the CPU.

``SyntheticLM.batch_at`` byte for byte; one ``make_train_step`` step from
the same params and batch (reduced yi-9b, float32, remat off) against the
JAX step, params within 5e-5 (0.05 of the learning rate: see the test);
``grad_accum=2`` equal to 1 at tests/test_training.py's tolerances; the
loss falling by 0.3 over 60 steps of reduced h2o-danube
(tests/test_training.py::test_loss_decreases);
training checkpoints written by either package restored by the other,
bit for bit; ``launch.train.main`` on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from conftest import smoke_model
from repro.training import checkpoint as jcheckpoint
from repro.training import optimizer as joptimizer
from repro.training.checkpoint import _flatten
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import SyntheticLM as JSyntheticLM
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.params import from_jax
from repro_torch.training import (DataConfig, OptimizerConfig, SyntheticLM,
                                  Trainer, TrainerConfig, checkpoint,
                                  make_train_step, optimizer)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers (each with
    every core's worth of threads) small eager ops slow down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [dict(vocab_size=100, seq_len=16,
                                     global_batch=4),
                                dict(vocab_size=32000, seq_len=33,
                                     global_batch=3, noise=0.2,
                                     num_dialects=1, seed=5)])
def test_batch_at_equals_jax(kw):
    ours, theirs = SyntheticLM(DataConfig(**kw)), JSyntheticLM(
        JDataConfig(**kw))
    for step in (0, 7, 123):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


@pytest.fixture(scope="module")
def yi():
    cfg, jmodel, jparams = smoke_model("yi-9b")
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=8, num_dialects=1))
    return jmodel, jparams, flat, data.batch_at(0)


def test_train_step_matches_jax(yi):
    jmodel, jparams, flat, batch = yi
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jmake_train_step(jmodel, opt_cfg, remat=False))
    jp, _, jm = jstep(jparams, joptimizer.init(jparams),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(reduce_for_smoke(get_config("yi-9b")))
    params = from_jax(flat, "cpu")
    step = make_train_step(model, opt_cfg, remat=False)
    tp, state, tm = step(params, optimizer.init(params),
                         {k: torch.tensor(v) for k, v in batch.items()})
    assert int(state.step) == 1
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = _flatten(jp)
    assert tp.keys() == want.keys()
    # Adam's first step moves a param by lr * g / (|g| + eps): about lr
    # for any gradient well above eps = 1e-8, but where |g| is near eps
    # the two sides' rounding (1e-5 relative in g) can move it by a few
    # hundredths of lr; 5e-5 = 0.05 lr
    for k, v in want.items():
        assert_allclose(tp[k].numpy(), np.asarray(v), rtol=1e-5, atol=5e-5,
                        err_msg=k)


def test_grad_accum_equivalence(yi):
    """grad_accum=2 over batch 8 == grad_accum=1 (same effective grads)."""
    _, _, flat, batch = yi
    model = build_model(reduce_for_smoke(get_config("yi-9b")))
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    outs = []
    for ga in (1, 2):
        params = from_jax(flat, "cpu")
        step = make_train_step(model, opt_cfg, grad_accum=ga, remat=False)
        p2, _, m = step(params, optimizer.init(params), tb)
        outs.append((p2, float(m["loss"])))
    assert abs(outs[0][1] - outs[1][1]) < 1e-3
    for k in outs[0][0]:
        assert_allclose(outs[0][0][k].numpy(), outs[1][0][k].numpy(),
                        rtol=2e-3, atol=2e-4)


def test_loss_decreases():
    cfg = reduce_for_smoke(get_config("h2o-danube-1.8b"))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=8, num_dialects=1))
    tr = Trainer(build_model(cfg),
                 OptimizerConfig(peak_lr=1e-3, warmup_steps=10,
                                 total_steps=60),
                 TrainerConfig(total_steps=60, log_every=20), device="cpu")
    hist = tr.fit(iter(data), log=lambda _: None)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3


def test_checkpoints_interoperate(tmp_path):
    _, _, jparams = smoke_model("h2o-danube-1.8b")
    model = build_model(reduce_for_smoke(get_config("h2o-danube-1.8b")))
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path / "port"))
    tr = Trainer(model, OptimizerConfig(), tcfg, seed=3, device="cpu")
    path = tr.save(5)
    # the port's file, restored by JAX's Trainer.restore
    tree, meta = jcheckpoint.restore(path, {"params": jparams})
    assert meta["step"] == 5 and meta["arch"] == "h2o-danube-1.8b"
    got = _flatten(tree["params"])
    assert got.keys() == tr.params.keys()
    for k, v in got.items():
        assert_array_equal(np.asarray(v), tr.params[k].numpy())
    # JAX's Trainer.save file, restored by the port's
    jpath = jcheckpoint.save(os.path.join(tmp_path, "step_1.ckpt"),
                             {"params": jparams}, step=1,
                             meta={"arch": "h2o-danube-1.8b"})
    tr.restore(jpath)
    for k, v in _flatten(jparams).items():
        assert tr.params[k].dtype == torch.float32
        assert_array_equal(tr.params[k].numpy(), np.asarray(v))
    assert checkpoint.latest(str(tmp_path / "port")).endswith("step_5.ckpt")


def test_launch_train_main_on_cpu(tmp_path, capsys):
    hist = tmp_path / "hist.json"
    rc = launch_train.main(["--arch", "yi-9b", "--steps", "6", "--seq-len",
                            "16", "--batch", "4", "--log-every", "3",
                            "--ckpt-dir", str(tmp_path), "--history-out",
                            str(hist), "--device", "cpu"])
    assert rc == 0 and hist.exists()
    assert (tmp_path / "step_6.ckpt").exists()
    assert "[train] yi-9b: loss" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_train.main(["--multi-pod", "--device", "cpu"])
