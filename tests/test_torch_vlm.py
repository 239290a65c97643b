"""The port's llama-3.2-vision backbone (family ``vlm``) against the JAX
package's, on the CPU.

The reduced config (``reduce_for_smoke``, fp32) is deepened to 6 layers
with cross blocks at layers 2 and 5, so there are two groups of two self
layers and the group indexing shows.  JAX init params are carried over
with ``params.from_jax`` after three perturbations, each of which would
otherwise hide a fault: the gates (0 at init, so tanh(0) silences every
cross block) are opened to a different value per group and per branch,
and ``q_norm_scale``/``k_norm_scale`` (ones at init) get noise.  The same
numpy inputs go through each JAX function and its port: ``_cross_kv``,
``cross_block_full`` (the port's through K1's plain version at Skv = T),
``cross_block_step`` (through K2's plain version), the forward logits,
prefill + 8 decode steps with ragged lengths, and the state's shapes.
Units at 2e-5, logits at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import vlm as jvlm
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, vlm
from repro_torch.models.transformer import layer_views
from repro_torch.params import from_jax, unflatten


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


ARCH = "llama-3.2-vision-11b"
UNIT = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _cfg(reduce, get):
    cfg = reduce(get(ARCH))
    return dataclasses.replace(cfg, num_layers=6, vlm=dataclasses.replace(
        cfg.vlm, cross_attn_layers=(2, 5)))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfg(jreduce, jget_config), _cfg(reduce_for_smoke,
                                                    get_config)
    jmodel = jbuild_model(jcfg)
    flat = {k: np.asarray(v) for k, v in _flatten(
        jmodel.init(jax.random.PRNGKey(0))).items()}
    rng = np.random.default_rng(7)
    flat["cross/gate_attn"] = np.asarray([1.0, 0.6], np.float32)
    flat["cross/gate_mlp"] = np.asarray([0.8, -0.5], np.float32)
    for k in ("cross/q_norm_scale", "cross/k_norm_scale"):
        flat[k] = (1 + 0.2 * rng.standard_normal(flat[k].shape)).astype(
            np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    return jcfg, jmodel, jp, tcfg, build_model(tcfg), from_jax(flat, "cpu")


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _image(cfg, B, seed=3):
    return _rand(B, cfg.vlm.image_tokens, cfg.vlm.vision_dim, seed=seed,
                 scale=0.5)


def _group(jp, tp, g):
    return (jax.tree_util.tree_map(lambda t: t[g], jp["cross"]),
            layer_views(tp, "cross")[g])


def test_cross_kv(pair):
    jcfg, _, jp, tcfg, _, tp = pair
    img = _image(jcfg, 2)
    jcp, tcp = _group(jp, tp, 1)
    jk, jv = jvlm._cross_kv(jcp, jnp.asarray(img), jcfg)
    tk, tv = vlm._cross_kv(tcp, torch.from_numpy(img), tcfg)
    assert tk.shape == (2, jcfg.vlm.image_tokens, jcfg.num_kv_heads,
                        jcfg.head_dim)
    assert_allclose(tk.numpy(), np.asarray(jk), **UNIT)
    assert_allclose(tv.numpy(), np.asarray(jv), **UNIT)


@pytest.mark.parametrize("g", [0, 1])
def test_cross_block_full_and_step(pair, g):
    """A sequence of 11 positions against the image's T = 8 keys (Skv != S)
    through ``cross_block_full``, and one token through
    ``cross_block_step``."""
    jcfg, _, jp, tcfg, _, tp = pair
    jcp, tcp = _group(jp, tp, g)
    img = _image(jcfg, 2, seed=4 + g)
    k, v = vlm._cross_kv(tcp, torch.from_numpy(img), tcfg)
    jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
    x = _rand(2, 11, jcfg.d_model, seed=5)
    want = jvlm.cross_block_full(jcp, jcfg, jnp.asarray(x), jk, jv)
    got = vlm.cross_block_full(tcp, tcfg, torch.from_numpy(x), k, v)
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)
    x1 = x[:, :1]
    want = jvlm.cross_block_step(jcp, jcfg, jnp.asarray(x1), jk, jv)
    got = vlm.cross_block_step(tcp, tcfg, torch.from_numpy(x1), k, v)
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)


def test_forward_logits(pair):
    jcfg, jmodel, jp, _, tmodel, tp = pair
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    img = _image(jcfg, 2)
    want = jmodel.forward(jp, {"tokens": jnp.asarray(toks),
                               "image_embeds": jnp.asarray(img)})
    got = tmodel.forward(tp, {"tokens": torch.from_numpy(toks),
                              "image_embeds": torch.from_numpy(img)})
    assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    # the image reaches the logits
    other = tmodel.forward(tp, {"tokens": torch.from_numpy(toks),
                                "image_embeds": torch.from_numpy(
                                    _image(jcfg, 2, seed=9))})
    assert float((other - got).abs().max()) > 1e-3


def test_prefill_then_decode(pair):
    """A ragged prefill (13 and 6 valid tokens) and 8 decode steps: logits
    at every step and the state (self caches, image K/V, lengths)."""
    jcfg, jmodel, jp, _, tmodel, tp = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    lens = np.asarray([13, 6], np.int32)
    img = _image(jcfg, 2)
    js = jmodel.init_state(2, 32)
    jl, js = jmodel.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray(lens),
                                 "image_embeds": jnp.asarray(img)}, js)
    ts = tmodel.init_state(2, 32, device="cpu")
    tl, ts = tmodel.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lens),
                                 "image_embeds": torch.from_numpy(img)}, ts)
    assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    for key in ("xk", "xv"):
        assert_allclose(ts[key].numpy(), np.asarray(js[key]), **UNIT)
    for b, n in enumerate(lens):
        assert_allclose(ts["k"][:, :, b, :n].numpy(),
                        np.asarray(js["k"])[:, :, b, :n], **UNIT)
    for _ in range(8):
        tok = rng.integers(0, jcfg.vocab_size, (2,)).astype(np.int32)
        jl, js = jmodel.decode(jp, jnp.asarray(tok), js)
        tl, ts = tmodel.decode(tp, torch.from_numpy(tok), ts)
        assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert ts["length"].tolist() == np.asarray(js["length"]).tolist()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_init_state_layout(pair, device):
    """The JAX state's keys, shapes and dtypes, on the meta device too
    (``InferenceEngine.state_batch_axes`` builds it there)."""
    jcfg, jmodel, _, _, tmodel, _ = pair
    want = jax.eval_shape(lambda: jmodel.init_state(3, 24))
    got = tmodel.init_state(3, 24, device=device)
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k
        assert t.device.type == device
    ngroups, nself = vlm._layout(tmodel.config)
    assert (ngroups, nself) == (2, 2)
    assert got["xk"].shape[2] == jcfg.vlm.image_tokens
