"""Each ported family's ``train_loss`` against the JAX package's, on the CPU.

The reduced float32 configs (``reduce_for_smoke``) of yi-9b, h2o-danube
(sliding window), command-r-plus (LayerNorm, parallel block, tied head),
qwen3-moe (the router aux loss), deepseek-v3 (MLA, first-k-dense, MoE and
the MTP head), llama-3.2-vision (cross-attention through K1's plain
version at Skv = T; its gates opened, as at 0 they silence every cross
block and its gradients), whisper-base, rwkv6 (the WKV recurrence through
K4's plain version) and zamba2 (K5's and K1's plain versions; its
``lora_b``, zeros at init, perturbed so the LoRA path carries a
gradient): the same params on both sides
(the port's seeded init, to JAX as numpy), one seeded batch, and ``jax.value_and_grad`` of
the JAX ``Model.loss`` against autograd of the port's.  Loss and metrics
at 1e-4, every parameter's gradient at 1e-4 relative to that leaf's
largest entry (elementwise; a gradient that is analytically zero, as the
key bias's, must stay below 1e-6 of the model's largest).  Also:
``chunked_ce`` at a vocab of 32768 against JAX's chunked loss and the
port's own full-logits loss; remat on and off give the same loss and
gradients.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from conftest import smoke_batch
from repro import opt as jopt
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.training.checkpoint import _flatten
from repro_torch import opt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model
from repro_torch.params import from_jax, to_flat, unflatten

ARCHS = ["yi-9b", "h2o-danube-1.8b", "command-r-plus-104b",
         "qwen3-moe-235b-a22b", "deepseek-v3-671b", "llama-3.2-vision-11b",
         "whisper-base", "rwkv6-1.6b", "zamba2-2.7b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: these reduced shapes gain
    nothing from more, and under the suite's parallel workers (each with
    every core's worth of threads) small eager ops slow down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates_open(flat):
    """vlm: open the cross blocks' tanh gates (0 at init); zamba2: perturb
    the shared block's LoRA up-projections (zeros at init)."""
    for k, v in (("cross/gate_attn", 0.7), ("cross/gate_mlp", -0.5)):
        if k in flat:
            flat[k] = np.full(flat[k].shape, v, np.float32)
    if "shared/lora_b" in flat:
        rng = np.random.default_rng(3)
        flat["shared/lora_b"] = rng.normal(
            0, 0.02, flat["shared/lora_b"].shape).astype(np.float32)
    return flat


@functools.cache
def _pair(arch, vocab=None):
    jcfg, tcfg = jreduce(jget_config(arch)), reduce_for_smoke(get_config(arch))
    if vocab is not None:
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        tcfg = dataclasses.replace(tcfg, vocab_size=vocab)
    # the port's seeded init (the JAX keys, shapes and dtypes), carried to
    # both sides: initializing through JAX would cost a compile per arch
    tmodel = build_model(tcfg)
    flat = _gates_open(to_flat(tmodel.init(0, "cpu")))
    jparams = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    batch = {k: np.asarray(v) for k, v in
             smoke_batch(jcfg, B=2, S=16, seed=1).items()}
    return jbuild_model(jcfg), jparams, tmodel, flat, batch


def _jax_loss(jmodel, jparams, batch, remat=False):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, remat=remat), has_aux=True))(jparams)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v) for k, v in _flatten(grads).items()})


def _port_loss(tmodel, flat, batch, remat=False):
    params = {k: v.requires_grad_(True)
              for k, v in from_jax(flat, "cpu").items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    loss, metrics = tmodel.loss(params, tb, remat=remat)
    keys = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in keys],
                                allow_unused=True)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {k: (np.zeros(params[k].shape, np.float32) if g is None
                 else g.numpy()) for k, g in zip(keys, grads)})


def _check_grads(got, want):
    """Each leaf elementwise at 1e-4 relative to its largest entry.  A leaf
    whose JAX gradient is below 1e-6 of the model's largest (analytically
    zero, e.g. the key bias, which the softmax cancels: rounding noise on
    both sides) must be below that floor in the port too."""
    assert got.keys() == want.keys()
    floor = 1e-6 * max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        scale = float(np.abs(want[k]).max())
        if scale < floor:
            assert float(np.abs(got[k]).max()) < floor, k
            continue
        assert_allclose(got[k], want[k], rtol=TOL["rtol"],
                        atol=TOL["atol"] * scale, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams, tmodel, flat, batch = _pair(arch)
    jl, jm, jg = _jax_loss(jmodel, jparams, batch)
    tl, tm, tg = _port_loss(tmodel, flat, batch)
    assert_allclose(tl, jl, **TOL)
    assert tm.keys() == jm.keys()
    for k in jm:
        assert_allclose(tm[k], jm[k], err_msg=k, **TOL)
    if arch == "qwen3-moe-235b-a22b":
        assert tm["aux"] > 0 and tl != tm["ce"]
    if arch == "deepseek-v3-671b":
        assert "mtp" in tm and any(np.abs(tg[k]).max() > 0
                                   for k in tg if k.startswith("mtp/"))
    _check_grads(tg, jg)


@pytest.fixture
def chunked_ce():
    for flags in (opt, jopt):
        flags.set_flags(chunked_ce=True)
    yield
    for flags in (opt, jopt):
        flags.set_flags(chunked_ce=False)


def test_chunked_ce_matches_jax_and_full_logits(chunked_ce):
    jmodel, jparams, tmodel, flat, batch = _pair("yi-9b", vocab=32768)
    jl, _, jg = _jax_loss(jmodel, jparams, batch)
    tl, _, tg = _port_loss(tmodel, flat, batch)
    assert_allclose(tl, jl, **TOL)
    _check_grads(tg, jg)
    opt.set_flags(chunked_ce=False)          # the port's full-logits loss
    fl, _, fg = _port_loss(tmodel, flat, batch)
    assert_allclose(tl, fl, **TOL)
    _check_grads(tg, fg)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v3-671b",
                                  "llama-3.2-vision-11b", "whisper-base",
                                  "rwkv6-1.6b", "zamba2-2.7b"])
def test_remat_agrees(arch):
    _, _, tmodel, flat, batch = _pair(arch)
    l0, _, g0 = _port_loss(tmodel, flat, batch, remat=False)
    l1, _, g1 = _port_loss(tmodel, flat, batch, remat=True)
    assert_allclose(l1, l0, rtol=1e-6)
    for k in g0:
        assert_allclose(g1[k], g0[k], rtol=1e-5, atol=1e-7, err_msg=k)
