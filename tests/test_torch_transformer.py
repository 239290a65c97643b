"""The port's dense transformer against the JAX package's, on the CPU.

Same numpy inputs and the same weights (JAX init, carried over with
``params.from_jax(checkpoint._flatten(...))``) through both packages at
reduced fp32 sizes.  Units are compared at 2e-5; whole-forward logits at
1e-4, because two layers of fp32 matmuls, norms and softmax summed in
another order (XLA vs. PyTorch's CPU kernels) drift by a few 1e-6 per op.
The JAX side runs its default path (``gqa_attention``); the port's
self-attention runs the flash kernel's plain version on the CPU.
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
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.fused_block import rms_norm_plain
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer
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


UNIT = dict(rtol=2e-5, atol=2e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
DENSE_ARCHS = ["yi-9b", "h2o-danube-1.8b", "command-r-plus-104b",
               "mistral-large-123b"]


def _cfgs(arch, **changes):
    """The reduced config in both packages, with the same changes."""
    return (dataclasses.replace(jreduce(jget_config(arch)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                **changes))


def _t(tree):
    """Nested numpy/jax leaves -> torch tensors (same nesting)."""
    return unflatten(from_jax({k: np.asarray(v) for k, v in
                               _flatten(tree).items()}, "cpu"))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("arch", ["yi-9b", "command-r-plus-104b"])
def test_apply_norm(arch):
    jcfg, tcfg = _cfgs(arch)
    x = _x((2, 5, jcfg.d_model))
    p = {"scale": _x((jcfg.d_model,), 1) + 1.0}
    if jcfg.norm_kind == "layernorm":
        p["nbias"] = _x((jcfg.d_model,), 2)
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jcfg)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), tcfg)
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)


def test_rms_norm_simple_and_rope():
    x = _x((2, 7, 3, 32))
    scale = _x((32,), 1)
    assert_allclose(
        rms_norm_plain(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jlayers.rms_norm_simple(jnp.asarray(x),
                                           jnp.asarray(scale))), **UNIT)
    pos = np.arange(3, 10)[None, :].repeat(2, 0)
    for theta in (10000.0, 75_000_000.0, 0.0):
        assert_allclose(
            tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta)), **UNIT)


@pytest.mark.parametrize("act,bias", [("swiglu", False), ("gelu", True)])
def test_apply_mlp(act, bias):
    jcfg, tcfg = _cfgs("yi-9b", act=act, use_bias=bias)
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), jcfg)
    if bias:
        jp = {**jp, "b_up": jnp.asarray(_x((jcfg.d_ff,), 4)),
              "b_down": jnp.asarray(_x((jcfg.d_model,), 5))}
    x = _x((2, 6, jcfg.d_model), 6)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), jcfg)
    got = tlayers.apply_mlp(_t(jp), torch.from_numpy(x), tcfg)
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)


@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, True)])
def test_project_qkv(bias, qk_norm):
    jcfg, tcfg = _cfgs("yi-9b", use_bias=bias, use_qk_norm=qk_norm)
    jp = jattn.init_attention(jax.random.PRNGKey(1), jcfg)
    if bias:
        jp = {**jp, **{k: jnp.asarray(_x(jp[k].shape, i))
                       for i, k in enumerate(("bq", "bk", "bv", "bo"))}}
    if qk_norm:
        jp = {**jp, "qnorm": jnp.asarray(_x((jcfg.head_dim,), 7) + 1),
              "knorm": jnp.asarray(_x((jcfg.head_dim,), 8) + 1)}
    x = _x((2, 9, jcfg.d_model), 9)
    want = jattn.project_qkv(jp, jnp.asarray(x), jcfg)
    got = tattn.project_qkv(_t(jp), torch.from_numpy(x), tcfg)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **UNIT)


@pytest.mark.parametrize("causal,window,ragged,cap", [
    (True, None, False, None), (True, 5, True, None),
    (False, None, True, 30.0)])
def test_gqa_attention_and_mask(causal, window, ragged, cap):
    B, S, H, K, hd = 2, 11, 4, 2, 32
    q, k, v = _x((B, S, H, hd), 1), _x((B, S, K, hd), 2), _x((B, S, K, hd), 3)
    lengths = np.array([S, 6], np.int32) if ragged else None
    jm = jattn.make_mask(S, S, causal=causal, window=window,
                         kv_lengths=None if lengths is None
                         else jnp.asarray(lengths))
    tm = tattn.make_mask(S, S, causal=causal, window=window,
                         kv_lengths=None if lengths is None
                         else torch.from_numpy(lengths))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jm, logit_cap=cap)
    got = tattn.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), tm, logit_cap=cap)
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)


@pytest.mark.parametrize("window,ragged", [(None, False), (4, True)])
def test_attention_block(window, ragged):
    """The port's block (flash kernel's plain version) against the JAX
    block's default materialised-scores path, on every valid position.  A
    padded query past its row's length that sees no valid key gets zeros
    from the flash kernel and a uniform average from the masked softmax
    (the JAX package's own two paths differ the same way)."""
    jcfg, tcfg = _cfgs("yi-9b")
    jp = jattn.init_attention(jax.random.PRNGKey(2), jcfg)
    x = _x((2, 13, jcfg.d_model), 4)
    lengths = np.array([13, 7], np.int32) if ragged else None
    want = jattn.attention_block(
        jp, jnp.asarray(x), jcfg, window=window,
        kv_lengths=None if lengths is None else jnp.asarray(lengths))
    got = tattn.attention_block(
        _t(jp), torch.from_numpy(x), tcfg, window=window,
        kv_lengths=None if lengths is None else torch.from_numpy(lengths))
    valid = np.arange(13)[None, :] < (np.full((2, 1), 13) if lengths is None
                                      else lengths[:, None])
    assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **UNIT)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jmodel = jbuild_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jmodel.forward(jp, {"tokens": jnp.asarray(tokens)})
    model = build_model(tcfg)
    params = from_jax(_flatten(jp), "cpu")
    got = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 24, jcfg.vocab_size)
    assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_forward_ragged_lengths_and_window_override():
    jcfg, tcfg = _cfgs("yi-9b")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    params = from_jax(_flatten(jp), "cpu")
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 20)).astype(np.int32)
    lengths = np.array([20, 9, 14], np.int32)
    from repro.models import transformer as jtransformer
    want, _ = jtransformer.forward(jp, jnp.asarray(tokens), jcfg,
                                   kv_lengths=jnp.asarray(lengths), window=6)
    got = transformer.forward(params, torch.from_numpy(tokens), tcfg,
                              kv_lengths=torch.from_numpy(lengths), window=6)
    valid = np.arange(20)[None, :] < lengths[:, None]   # see attention_block
    assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **LOGITS)


@pytest.mark.parametrize("arch,dtype", [
    ("yi-9b", "float32"), ("command-r-plus-104b", "float32"),
    ("h2o-danube-1.8b", "bfloat16"), ("rwkv6-1.6b", "float32"),
    ("zamba2-2.7b", "bfloat16")])
def test_init_matches_jax_keys_shapes_dtypes(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    # the keys checkpoint._flatten writes, without materialising the leaves
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = build_model(tcfg).init(0, "cpu")
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k


def test_init_is_seeded():
    _, tcfg = _cfgs("yi-9b")
    a, b, c = (build_model(tcfg).init(s, "cpu") for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers/attn/wq"], c["layers/attn/wq"])


@pytest.mark.parametrize("arch,extra", [
    ("llama-3.2-vision-11b", "image_embeds"), ("whisper-base", "frames")])
def test_frontend_families_build_like_jax(arch, extra):
    """build_model builds the vlm and encdec families (tests/test_torch_vlm.py
    and test_torch_encdec.py hold them to JAX): init's keys, shapes and
    dtypes are the JAX init's, and a forward with the family's extras runs
    to finite (B, S, V) logits."""
    jcfg, tcfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(tcfg)
    params = model.init(0, "cpu")
    assert set(params) == set(want)
    for k, v in params.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k
    dims = ((tcfg.vlm.image_tokens, tcfg.vlm.vision_dim) if tcfg.vlm
            else (tcfg.encdec.encoder_frames, tcfg.d_model))
    logits = model.forward(params, {
        "tokens": torch.ones((2, 5), dtype=torch.int32),
        extra: torch.from_numpy(_x((2, *dims), scale=0.1))})
    assert logits.shape == (2, 5, tcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(tcfg, family="audio"))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b",
                                  "llama-3.2-vision-11b", "whisper-base"])
def test_dense_module_refuses_other_families(arch):
    """build_model routes ssm/hybrid to their own modules; the transformer
    module called directly on such a config (or on a family no slice has
    ported) refuses it instead of building a dense model from it."""
    cfg = reduce_for_smoke(get_config(arch))
    with pytest.raises(ValueError, match="transformer.py serves"):
        transformer.init_params(0, cfg, "cpu")
    with pytest.raises(ValueError, match="transformer.py serves"):
        transformer.init_state(cfg, 1, 8, None, None, "cpu")


def test_generate_entry_points_raise():
    """The generate entry points run on CPU tensors when asked for the CPU
    (tests/test_torch_decode.py holds them to JAX); without a device they
    run on the card, and with no card visible ``init_state`` raises
    instead of falling back to the CPU."""
    model = build_model(reduce_for_smoke(get_config("yi-9b")))
    params = model.init(0, "cpu")
    state = model.init_state(2, 16, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.config.vocab_size, (2, 5)).astype(np.int32))
    logits, state = model.prefill(params, {"tokens": tokens}, state)
    assert logits.shape == (2, model.config.vocab_size)
    logits, state = model.decode(params, logits.argmax(-1), state)
    assert logits.shape == (2, model.config.vocab_size)
    assert state["length"].tolist() == [6, 6]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_state(2, 16)
