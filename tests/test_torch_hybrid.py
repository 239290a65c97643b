"""The port's zamba2 hybrid (family ``hybrid``: a Mamba-2 backbone plus one
shared attention block) against the JAX package's, on the CPU.

The JAX smoke params (``reduce_for_smoke``: 2 layers, shared block period
1, window 64, Mamba-2 heads of 32 with state 16, fp32) are carried over
with ``params.from_jax``.  ``lora_b`` is initialised to zeros in both
packages, so every test perturbs it with numpy noise first: otherwise a
LoRA fault would pass unseen.  The same numpy inputs go through each JAX
function and its port: ``_causal_conv``, ``mamba2_full`` (through K5's
plain version; the JAX model runs its own ``ssd_chunked``),
``mamba2_step``, ``shared_block_full``, the forward logits, prefill +
decode against the forward, a ragged prefill against a clean batch-of-one
prefill, the ring cache wrapping (tests/test_ring_cache.py), and decode
steps from a JAX-made state.  Units at 2e-5; what runs the SSD at 1e-4;
logits at 1e-4 relative to max|logits| + 1.  The softplus of dt differs
by construction: ``F.softplus`` returns x above 20 where
``jax.nn.softplus`` is exact, a difference below 2.1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import hybrid as jhybrid
from repro.models import mamba2 as jmamba2
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, hybrid, mamba2
from repro_torch.models.transformer import layer_views, subtree
from repro_torch.params import from_jax, state_from_jax, unflatten


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


ARCH = "zamba2-2.7b"
UNIT = dict(rtol=2e-5, atol=2e-5)
SSD = dict(rtol=1e-4, atol=1e-4)


def perturbed_params(seed=0):
    """JAX smoke params with ``shared/lora_b`` replaced by noise: (JAX
    tree, port flat dict)."""
    jcfg = jreduce(jget_config(ARCH))
    flat = {k: np.asarray(v) for k, v in _flatten(
        jbuild_model(jcfg).init(jax.random.PRNGKey(seed))).items()}
    lb = flat["shared/lora_b"]
    flat["shared/lora_b"] = (np.random.default_rng(seed + 100)
                             .standard_normal(lb.shape) * 0.05
                             ).astype(lb.dtype)
    return (jax.tree_util.tree_map(jnp.asarray, unflatten(flat)),
            from_jax(flat, "cpu"))


@pytest.fixture(scope="module")
def pair():
    jcfg = jreduce(jget_config(ARCH))
    tcfg = reduce_for_smoke(get_config(ARCH))
    jp, tp = perturbed_params()
    assert float(jnp.abs(jp["shared"]["lora_b"]).max()) > 0.01
    return jcfg, jbuild_model(jcfg), jp, tcfg, build_model(tcfg), tp


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _logits_close(got, want):
    scale = float(np.abs(want).max()) + 1.0
    assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                    rtol=0, atol=1e-4)


def _mamba_layer(pair, i=0):
    _, _, jp, _, _, tp = pair
    return (jax.tree_util.tree_map(lambda t: t[i], jp["mamba"]),
            layer_views(tp, "mamba")[i])


def test_causal_conv(pair):
    jl, tl = _mamba_layer(pair)
    C = tl["conv_w"].shape[1]
    x, st = _rand(2, 9, C, seed=1), _rand(2, 3, C, seed=2)
    want = jmamba2._causal_conv(jnp.asarray(x), jl["conv_w"], jl["conv_b"],
                                jnp.asarray(st))
    got = mamba2._causal_conv(torch.from_numpy(x), tl["conv_w"],
                              tl["conv_b"], torch.from_numpy(st))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **UNIT)


@pytest.mark.parametrize("lengths", [None, [40, 9, 23]])
def test_mamba2_full(pair, lengths):
    jcfg, _, _, tcfg, _, _ = pair
    jl, tl = _mamba_layer(pair, 1)
    inner, H, P, N = mamba2.mamba2_dims(tcfg)
    K = tcfg.ssm.conv_kernel
    B, T = 3, 40
    x = _rand(B, T, tcfg.d_model, seed=3)
    conv = _rand(B, K - 1, inner + 2 * N, seed=4)
    h0 = _rand(B, H, P, N, seed=5, scale=0.3)
    jkw, tkw = {}, {}
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
        jkw, tkw = ({"lengths": jnp.asarray(lens)},
                    {"lengths": torch.from_numpy(lens)})
    want = jmamba2.mamba2_full(jl, jcfg, jnp.asarray(x), jnp.asarray(conv),
                               jnp.asarray(h0), **jkw)
    got = mamba2.mamba2_full(tl, tcfg, torch.from_numpy(x),
                             torch.from_numpy(conv), torch.from_numpy(h0),
                             **tkw)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **SSD)


def test_mamba2_step_and_ssd_step(pair):
    jcfg, _, _, tcfg, _, _ = pair
    jl, tl = _mamba_layer(pair)
    inner, H, P, N = mamba2.mamba2_dims(tcfg)
    x1 = _rand(2, 1, tcfg.d_model, seed=6)
    conv = _rand(2, tcfg.ssm.conv_kernel - 1, inner + 2 * N, seed=7)
    h = _rand(2, H, P, N, seed=8, scale=0.3)
    want = jmamba2.mamba2_step(jl, jcfg, jnp.asarray(x1), jnp.asarray(conv),
                               jnp.asarray(h))
    got = mamba2.mamba2_step(tl, tcfg, torch.from_numpy(x1),
                             torch.from_numpy(conv), torch.from_numpy(h))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **UNIT)


@pytest.mark.parametrize("S,lengths", [(30, None), (80, [80, 50])])
def test_shared_block_full(pair, S, lengths):
    """The shared block with its per-application LoRA (perturbed), over a
    sequence longer than the window in the second case.  Only valid query
    positions are compared (see ROADMAP section 3)."""
    jcfg, _, jp, tcfg, _, tp = pair
    sp = subtree(tp, "shared")
    B, d = 2, tcfg.d_model
    x, e0 = _rand(B, S, d, seed=9), _rand(B, S, d, seed=10)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jargs = (jp["shared"], jcfg, jnp.asarray(x), jnp.asarray(e0),
             jp["shared"]["lora_a"][1], jp["shared"]["lora_b"][1],
             jnp.arange(S)[None, :], jcfg.hybrid.shared_window)
    want, (wk, wv) = jhybrid.shared_block_full(
        *jargs, kv_lengths=None if lens is None else jnp.asarray(lens))
    got, (gk, gv) = hybrid.shared_block_full(
        sp, tcfg, torch.from_numpy(x), torch.from_numpy(e0),
        sp["lora_a"][1], sp["lora_b"][1], torch.arange(S)[None, :],
        tcfg.hybrid.shared_window,
        kv_lengths=None if lens is None else torch.from_numpy(lens))
    valid = (np.ones((B, S), bool) if lens is None
             else np.arange(S)[None, :] < lens[:, None])
    assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **UNIT)
    assert_allclose(gk.numpy(), np.asarray(wk), **UNIT)
    assert_allclose(gv.numpy(), np.asarray(wv), **UNIT)


@pytest.mark.parametrize("S", [40, 100])
def test_forward_logits_match_jax(pair, S):
    jcfg, jmodel, jp, _, tmodel, tp = pair
    tokens = _tokens(jcfg, 2, S)
    want = jmodel.forward(jp, {"tokens": jnp.asarray(tokens)})
    got = tmodel.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape
    _logits_close(got.numpy(), want)


@pytest.mark.parametrize("S,steps", [(12, 3), (70, 4)])
def test_prefill_decode_matches_forward(pair, S, steps):
    """Prefill + decode steps reproduce the windowed forward; at S=70 the
    64-slot shared cache is a ring that prefill fills wrapped and decode
    keeps wrapping (tests/test_ring_cache.py)."""
    jcfg, jmodel, jp, tcfg, tmodel, tp = pair
    B = 2
    tokens = torch.from_numpy(_tokens(jcfg, B, S + steps, seed=3))
    full = tmodel.forward(tp, {"tokens": tokens}).numpy()
    _logits_close(full, jmodel.forward(jp, {"tokens": jnp.asarray(
        tokens.numpy())}))
    state = tmodel.init_state(B, 128, device="cpu")
    assert state["shared_k"].shape[2] == tcfg.hybrid.shared_window
    logits, state = tmodel.prefill(tp, {"tokens": tokens[:, :S], "lengths":
                                        torch.full((B,), S)}, state)
    _logits_close(logits.numpy(), full[:, S - 1])
    for t in range(steps):
        logits, state = tmodel.decode(tp, tokens[:, S + t], state)
        _logits_close(logits.numpy(), full[:, S + t])


def test_ragged_prefill_matches_batch_of_one(pair):
    jcfg, _, _, _, tmodel, tp = pair
    tokens = torch.from_numpy(_tokens(jcfg, 2, 12, seed=5))
    state = tmodel.init_state(2, 32, device="cpu")
    logits, state = tmodel.prefill(
        tp, {"tokens": tokens, "lengths": torch.tensor([8, 12])}, state)
    one = tmodel.init_state(1, 32, device="cpu")
    tok1 = torch.cat([tokens[:1, :8], torch.zeros((1, 4), dtype=torch.int32)],
                     dim=1)
    logits1, one = tmodel.prefill(tp, {"tokens": tok1,
                                       "lengths": torch.tensor([8])}, one)
    _logits_close(logits[:1].numpy(), logits1.numpy())
    for key in ("conv", "ssd", "shared_k", "shared_v"):
        assert_allclose(state[key][:, :1].numpy(), one[key].numpy(), **SSD)


def test_decode_from_a_jax_state(pair):
    """A JAX ragged prefill's state (conv, SSD and the ring caches),
    carried across with ``state_from_jax``, decodes in the port as in
    JAX, past the ring's wrap."""
    jcfg, jmodel, jp, tcfg, tmodel, tp = pair
    tokens = _tokens(jcfg, 2, 66, seed=7)
    lens = jnp.asarray([66, 30], jnp.int32)
    _, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens),
                                    "lengths": lens},
                               jmodel.init_state(2, 128))
    state = state_from_jax(jstate, "cpu")
    assert set(state) == {"conv", "ssd", "shared_k", "shared_v", "length"}
    nxt = _tokens(jcfg, 2, 3, seed=8)
    for t in range(3):
        want, jstate = jmodel.decode(jp, jnp.asarray(nxt[:, t]), jstate)
        got, state = tmodel.decode(tp, torch.from_numpy(nxt[:, t]), state)
        _logits_close(got.numpy(), want)
    for key in state:
        assert_allclose(state[key].numpy(), np.asarray(jstate[key]), **SSD)
