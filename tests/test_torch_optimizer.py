"""The port's AdamW and LR schedules against the JAX package's, on the CPU.

``lr_at`` at the JAX test's points and over all three schedules; one
``update`` from the same params, gradients and state on the reduced yi-9b
params (float32), with float32 and bfloat16 moments, clipping active (the
gradients' norm above ``grad_clip``), then a second update from the first
one's state; the decay mask over every assigned arch's param keys; and
``global_norm``.  Float32 results within 1e-6 relative (the update's math
is elementwise float32 in both, the norm's sum order differs); bfloat16
moments within one bf16 step, and the params after them within what
one such step moves an update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import ASSIGNED_ARCHS, get_config, reduce_for_smoke
from repro.models import build_model
from repro.training import optimizer as joptimizer
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import reduce_for_smoke as treduce
from repro_torch.models import build_model as tbuild_model
from repro_torch.params import from_jax, to_flat, unflatten
from repro_torch.training import optimizer
from repro_torch.training.optimizer import OptimizerConfig

F32 = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers (each with
    every core's worth of threads) small eager ops slow down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    cfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1, schedule=schedule)
    steps = np.arange(0, 121, 3)
    got = np.array([float(optimizer.lr_at(int(s), cfg)) for s in steps])
    want = np.array([float(joptimizer.lr_at(jnp.asarray(s), cfg))
                     for s in steps])
    assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_lr_schedule_test_points():
    cfg = OptimizerConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(optimizer.lr_at(s, cfg)) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert 0.1 < lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6


@pytest.fixture(scope="module")
def yi():
    """Reduced yi-9b params (JAX tree and the port's flat dict; the port's
    seeded init, which needs no JAX compile) and seeded gradients large
    enough that clipping acts."""
    flat = to_flat(tbuild_model(treduce(tget_config("yi-9b"))).init(0, "cpu"))
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    rng = np.random.default_rng(0)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in flat.items()}
    return params, flat, grads


def _step_pair(yi, moment_dtype):
    params, flat, grads = yi
    cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                          moment_dtype=moment_dtype)
    jgrads = jax.tree_util.tree_map(
        jnp.asarray, _unflatten_like(params, grads))
    jstate = joptimizer.init(params, moment_dtype)
    tparams = from_jax(flat, "cpu")
    tgrads = {k: torch.tensor(v) for k, v in grads.items()}
    tstate = optimizer.init(tparams, moment_dtype)
    jupdate = jax.jit(joptimizer.update, static_argnums=3)
    out = []
    for _ in range(2):
        params, jstate, jm = jupdate(jgrads, jstate, params, cfg)
        tparams, tstate, tm = optimizer.update(tgrads, tstate, tparams, cfg)
        snap = lambda d: {k: v.clone() for k, v in d.items()}  # in place
        out.append((params, jstate, jm, snap(tparams),
                    tstate._replace(mu=snap(tstate.mu), nu=snap(tstate.nu)),
                    tm))
    return out


def _unflatten_like(tree, flat):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = list(_flatten(tree))
    return jax.tree_util.tree_unflatten(treedef, [flat[k] for k in keys])


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_update_matches_jax(yi, moment_dtype):
    steps = _step_pair(yi, moment_dtype)
    mom = F32 if moment_dtype is None else dict(rtol=8e-3, atol=1e-30)
    # with bf16 moments one bf16 step (2^-8 relative) of a moment moves the
    # second update by up to lr * 2^-7 = 7.8e-6 in a param
    ptol = F32 if moment_dtype is None else dict(rtol=1e-6, atol=7.8e-6)
    for params, jstate, jm, tparams, tstate, tm in steps:
        assert float(jm["grad_norm"]) > 1.0          # clipping is active
        assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                        rtol=1e-6)
        assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        assert int(tstate.step) == int(jstate.step)
        for name, jtree, tflat, tol in (("params", params, tparams, ptol),
                                        ("mu", jstate.mu, tstate.mu, mom),
                                        ("nu", jstate.nu, tstate.nu, mom)):
            want = {k: np.asarray(v, np.float32)
                    for k, v in _flatten(jtree).items()}
            got = {k: v.float().numpy() for k, v in tflat.items()}
            assert got.keys() == want.keys()
            for k in want:
                assert tflat[k].dtype == {
                    None: torch.float32, "bfloat16": torch.bfloat16}[
                        moment_dtype if name != "params" else None]
                assert_allclose(got[k], want[k], err_msg=f"{name} {k}",
                                **tol)


def test_update_writes_in_place(yi):
    _, flat, grads = yi
    cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    tgrads = {k: torch.tensor(v) for k, v in grads.items()}
    params = from_jax(flat, "cpu")
    before = {k: v.clone() for k, v in params.items()}
    state = optimizer.init(params)
    new_p, new_s, _ = optimizer.update(tgrads, state, params, cfg)
    for k in params:
        assert new_p[k] is params[k] and new_s.mu[k] is state.mu[k]
        assert new_s.nu[k] is state.nu[k]
        assert not torch.equal(params[k], before[k])
    assert int(state.step) == 0 and int(new_s.step) == 1


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decay_mask_selects_the_same_keys(arch):
    model = build_model(reduce_for_smoke(get_config(arch)))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    paths = [path for path, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    keys = {"/".join(str(p.key) for p in path): path for path in paths}
    want = {k for k, path in keys.items() if joptimizer._decayable(path)}
    got = {k for k in keys if optimizer._decayable(k)}
    assert got == want and 0 < len(got) < len(paths)


def test_global_norm_matches_jax(yi):
    params, flat, _ = yi
    got = float(optimizer.global_norm(from_jax(flat, "cpu")))
    assert_allclose(got, float(joptimizer.global_norm(params)), rtol=1e-6)
    assert to_flat(from_jax(flat, "cpu")).keys() == flat.keys()
