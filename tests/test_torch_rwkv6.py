"""The port's rwkv6 (family ``ssm``) against the JAX package's, on the CPU.

The JAX smoke params (``reduce_for_smoke``: 2 layers, d_model 256, head
size 32, fp32) are carried over with ``params.from_jax``; the same numpy
inputs go through each JAX function and its port: ``group_norm``,
``_ddlerp``, ``time_mix_full`` (through K4's plain version; the JAX model
runs its own ``wkv_chunked``), ``wkv_step``, ``channel_mix``, the forward
logits, prefill + decode against the forward (the
tests/test_decode_consistency.py contract), a ragged prefill against a
clean batch-of-one prefill, and decode steps from a JAX-made state carried
across with ``state_from_jax``.  Units at 2e-5; whatever runs the WKV at
1e-4 (tests/test_kernels.py's WKV tolerance); logits at 1e-4 relative to
max|logits| + 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from conftest import smoke_model
from repro.models import rwkv6 as jrwkv6
from repro.models.layers import group_norm as jgroup_norm
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, rwkv6
from repro_torch.models.layers import group_norm
from repro_torch.models.transformer import layer_views
from repro_torch.params import from_jax, state_from_jax


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


ARCH = "rwkv6-1.6b"
UNIT = dict(rtol=2e-5, atol=2e-5)
WKV = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jcfg, jmodel, jp = smoke_model(ARCH)
    tcfg = reduce_for_smoke(get_config(ARCH))
    return jcfg, jmodel, jp, tcfg, build_model(tcfg), from_jax(_flatten(jp),
                                                               "cpu")


def _layer(pair, i=0):
    _, _, jp, _, _, tp = pair
    return (jax.tree_util.tree_map(lambda t: t[i], jp["layers"]),
            layer_views(tp, "layers")[i])


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _logits_close(got, want):
    scale = float(np.abs(want).max()) + 1.0
    assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                    rtol=0, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_group_norm_population_variance(groups):
    x = _rand(3, 5, 64, seed=1) * 3.0 + 1.0
    scale, bias = _rand(64, seed=2), _rand(64, seed=3)
    want = jgroup_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                       groups)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                     torch.from_numpy(bias), groups)
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)


def test_ddlerp(pair):
    jl, tl = _layer(pair)
    D = pair[0].d_model
    x, xp = _rand(2, 7, D, seed=4), _rand(2, 7, D, seed=5)
    want = jrwkv6._ddlerp(jl, jnp.asarray(x), jnp.asarray(xp))
    got = rwkv6._ddlerp(tl, torch.from_numpy(x), torch.from_numpy(xp))
    assert set(got) == set(want)
    for k in want:
        assert_allclose(got[k].numpy(), np.asarray(want[k]), **UNIT)


@pytest.mark.parametrize("lengths", [None, [20, 9, 14]])
def test_time_mix_full(pair, lengths):
    jcfg, _, _, tcfg, _, _ = pair
    jl, tl = _layer(pair, 1)
    H, N = rwkv6.rwkv_dims(tcfg)
    B, T, D = 3, 20, tcfg.d_model
    x = _rand(B, T, D, seed=6)
    shift, S0 = _rand(B, D, seed=7), _rand(B, H, N, N, seed=8, scale=0.3)
    jkw, tkw = {}, {}
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
        mask = np.arange(T)[None, :] < lens[:, None]
        jkw = dict(mask=jnp.asarray(mask), lengths=jnp.asarray(lens))
        tkw = dict(mask=torch.from_numpy(mask),
                   lengths=torch.from_numpy(lens))
    want = jrwkv6.time_mix_full(jl, jcfg, jnp.asarray(x), jnp.asarray(shift),
                                jnp.asarray(S0), **jkw)
    got = rwkv6.time_mix_full(tl, tcfg, torch.from_numpy(x),
                              torch.from_numpy(shift), torch.from_numpy(S0),
                              **tkw)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **WKV)


def test_wkv_step_and_channel_mix(pair):
    _, _, _, tcfg, _, _ = pair
    jl, tl = _layer(pair)
    H, N = rwkv6.rwkv_dims(tcfg)
    r, k, v = (_rand(2, H, N, seed=s) for s in (9, 10, 11))
    logw = -np.exp(_rand(2, H, N, seed=12))
    u, S = _rand(H, N, seed=13), _rand(2, H, N, N, seed=14)
    want = jrwkv6.wkv_step(*(jnp.asarray(t) for t in (r, k, v, logw, u, S)))
    got = rwkv6.wkv_step(*(torch.from_numpy(t)
                           for t in (r, k, v, logw, u, S)))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **UNIT)
    D = tcfg.d_model
    x, xp = _rand(2, 5, D, seed=15), _rand(2, 5, D, seed=16)
    want = jrwkv6.channel_mix(jl, jnp.asarray(x), jnp.asarray(xp))
    got = rwkv6.channel_mix(tl, torch.from_numpy(x), torch.from_numpy(xp))
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S", [40, 64])
def test_forward_logits_match_jax(pair, S):
    jcfg, jmodel, jp, _, tmodel, tp = pair
    tokens = _tokens(jcfg, 2, S)
    want = jmodel.forward(jp, {"tokens": jnp.asarray(tokens)})
    got = tmodel.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape
    _logits_close(got.numpy(), want)


def test_prefill_decode_matches_forward(pair):
    jcfg, jmodel, jp, _, tmodel, tp = pair
    B, S, steps = 2, 12, 3
    tokens = torch.from_numpy(_tokens(jcfg, B, S + steps, seed=3))
    full = tmodel.forward(tp, {"tokens": tokens}).numpy()
    want = np.asarray(jmodel.forward(jp, {"tokens": jnp.asarray(
        tokens.numpy())}))
    _logits_close(full, want)
    state = tmodel.init_state(B, S + steps + 4, device="cpu")
    logits, state = tmodel.prefill(tp, {"tokens": tokens[:, :S], "lengths":
                                        torch.full((B,), S)}, state)
    _logits_close(logits.numpy(), full[:, S - 1])
    for t in range(steps):
        logits, state = tmodel.decode(tp, tokens[:, S + t], state)
        _logits_close(logits.numpy(), full[:, S + t])
    assert state["length"].tolist() == [S + steps] * B


def test_ragged_prefill_matches_batch_of_one(pair):
    """Row 0 holds 8 valid tokens of 12: its logits and recurrent state
    equal a clean batch-of-one prefill of those 8 (pad steps get k=v=0 and
    decay 1; the shifts are gathered at the last valid token)."""
    jcfg, _, _, _, tmodel, tp = pair
    tokens = torch.from_numpy(_tokens(jcfg, 2, 12, seed=5))
    state = tmodel.init_state(2, 16, device="cpu")
    logits, state = tmodel.prefill(
        tp, {"tokens": tokens, "lengths": torch.tensor([8, 12])}, state)
    one = tmodel.init_state(1, 16, device="cpu")
    tok1 = torch.cat([tokens[:1, :8], torch.zeros((1, 4), dtype=torch.int32)],
                     dim=1)
    logits1, one = tmodel.prefill(tp, {"tokens": tok1,
                                       "lengths": torch.tensor([8])}, one)
    _logits_close(logits[:1].numpy(), logits1.numpy())
    for key in ("tm_shift", "cm_shift", "wkv"):
        assert_allclose(state[key][:, :1].numpy(), one[key].numpy(), **WKV)
    assert state["length"].tolist() == [8, 12]


def test_decode_from_a_jax_state(pair):
    """A JAX ragged prefill's state, carried across with
    ``state_from_jax``, decodes in the port as it does in JAX."""
    jcfg, jmodel, jp, _, tmodel, tp = pair
    tokens = _tokens(jcfg, 3, 10, seed=7)
    lens = jnp.asarray([10, 4, 7], jnp.int32)
    _, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens),
                                    "lengths": lens},
                               jmodel.init_state(3, 32))
    state = state_from_jax(jstate, "cpu")
    assert state["wkv"].dtype == torch.float32
    assert state["length"].dtype == torch.int32
    nxt = _tokens(jcfg, 3, 3, seed=8)
    for t in range(3):
        want, jstate = jmodel.decode(jp, jnp.asarray(nxt[:, t]), jstate)
        got, state = tmodel.decode(tp, torch.from_numpy(nxt[:, t]), state)
        _logits_close(got.numpy(), want)
    for key in ("tm_shift", "cm_shift", "wkv", "length"):
        assert_allclose(state[key].numpy(), np.asarray(jstate[key]), **WKV)
