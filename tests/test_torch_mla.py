"""The port's MLA (deepseek-v3's multi-head latent attention) against the
JAX package's, on the CPU.

Same numpy inputs and the same weights (JAX init, carried over with
``params.from_jax``) at reduced fp32 sizes: the full-sequence block (per
head [nope | rope] queries, the [c_kv | k_rope] latent and per-head
[k_nope | v] from ``kv_b``, scores and P.V in fp32) and the absorbed
decode block (W_UK folded into q, attention in the latent space; the JAX
package's default ``attn_dtype`` branch) within 2e-5, and the latent cache
they write.  Then the model: prefill + decode against one forward over the
same tokens (tests/test_decode_consistency.py), the decode state's keys
and shapes against JAX's (``cache_dense``/``cache`` of ``ckv``/``krope``;
an MLA cache never rings), a JAX state carried over with
``state_from_jax``, and the paging refusal.
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
from repro.models import paged as jpaged
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import PagedInferenceEngine
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, paged
from repro_torch.params import flatten, from_jax, state_from_jax, to_flat
from repro_torch.params import unflatten


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
DSV3 = "deepseek-v3-671b"


def _cfgs(**changes):
    return (dataclasses.replace(jreduce(jget_config(DSV3)), **changes),
            dataclasses.replace(reduce_for_smoke(get_config(DSV3)),
                                **changes))


def _t(tree):
    return unflatten(from_jax({k: np.asarray(v) for k, v in
                               _flatten(tree).items()}, "cpu"))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _perturbed_mla(jcfg, seed=4):
    """JAX MLA params with the norm scales moved off 1 (a bug that swapped
    the two scales would pass with both at ones)."""
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg)
    return {**jp,
            "q_a_scale": jnp.asarray(_x(jp["q_a_scale"].shape, 1) * 0.2 + 1),
            "kv_a_scale": jnp.asarray(_x(jp["kv_a_scale"].shape, 2) * 0.2
                                      + 1)}


def test_init_mla_keys_shapes():
    jcfg, tcfg = _cfgs()
    want = jattn.init_mla(jax.random.PRNGKey(0), jcfg)
    got = tattn.init_mla(torch.Generator().manual_seed(0), tcfg)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(
            want[k].dtype), k


@pytest.mark.parametrize("ragged", [False, True])
def test_mla_attention_block_matches_jax(ragged):
    jcfg, tcfg = _cfgs()
    jp = _perturbed_mla(jcfg)
    B, S = 2, 13
    x = _x((B, S, jcfg.d_model), 5)
    lengths = np.array([13, 6], np.int32) if ragged else None
    pos = np.arange(3, 3 + S)[None, :]
    want = jattn.mla_attention_block(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
        kv_lengths=None if lengths is None else jnp.asarray(lengths))
    got = tattn.mla_attention_block(
        _t(jp), torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
        kv_lengths=None if lengths is None else torch.from_numpy(lengths))
    assert_allclose(got.numpy(), np.asarray(want), **UNIT)
    # the latent halves prefill writes into the cache
    jc, jr = jattn._mla_ckv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    _, tc, tr = tattn.mla_full(_t(jp), torch.from_numpy(x), tcfg,
                               positions=torch.from_numpy(pos))
    assert_allclose(tc.numpy(), np.asarray(jc), **UNIT)
    assert_allclose(tr.numpy(), np.asarray(jr), **UNIT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_block_matches_jax(dtype):
    """The absorbed decode on a random latent cache (rows at lengths 5 and
    11, one past its cache's end is dropped as JAX drops it): the output
    and the written slots."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    m = jcfg.mla
    jp = _perturbed_mla(jcfg)
    B, Smax = 3, 16
    x1 = _x((B, 1, jcfg.d_model), 6)
    ck = _x((B, Smax, m.kv_lora_rank), 7, 0.5)
    kr = _x((B, Smax, m.rope_head_dim), 8, 0.5)
    lens = np.array([5, 11, Smax], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jck, jkr = (jnp.asarray(a).astype(jdt) for a in (x1, ck, kr))
    want, wck, wkr = jattn.mla_decode_block(jp, jx, jck, jkr,
                                            jnp.asarray(lens), jcfg)
    tp = _t(jp)
    tx, tck, tkr = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        tp["q_a"].dtype) for a in (jx, jck, jkr))
    got, gck, gkr = tattn.mla_decode_block(tp, tx, tck, tkr,
                                           torch.from_numpy(lens), tcfg)
    assert gck is tck and gkr is tkr            # written in place
    tol = UNIT if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                    **tol)
    for g, w in ((gck, wck), (gkr, wkr)):
        assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


def _pair(**changes):
    jcfg, tcfg = _cfgs(**changes)
    jmodel = jbuild_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jp, build_model(tcfg), from_jax(_flatten(jp), "cpu")


@pytest.mark.parametrize("steps", [2, 5])
def test_prefill_decode_matches_forward(steps):
    """tests/test_decode_consistency.py on the port: prefill(prompt) + N
    absorbed decode steps reproduce the teacher-forced forward (fp32,
    1e-4 x (max|logit| + 1))."""
    _, _, model, params = _pair()
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.config.vocab_size, (B, S + steps)).astype(np.int32))
    full = model.forward(params, {"tokens": toks})
    state = model.init_state(B, S + steps + 4, device="cpu")
    logits, state = model.prefill(params, {"tokens": toks[:, :S]}, state)
    tol = 1e-4 * (float(full.abs().max()) + 1.0)
    assert float((logits - full[:, S - 1]).abs().max()) < tol
    for t in range(steps):
        logits, state = model.decode(params, toks[:, S + t], state)
        assert float((logits - full[:, S + t]).abs().max()) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_matches_jax(dtype):
    """``cache_dense`` and ``cache`` of ``ckv``/``krope``, keys, shapes
    and dtypes; the window argument does not ring an MLA cache."""
    jmodel, _, model, _ = _pair(dtype=dtype)
    want = _flatten(jmodel.init_state(3, 64))
    got = to_flat(flatten(model.init_state(3, 64, device="cpu")))
    assert set(got) == set(want) == {
        "cache_dense/ckv", "cache_dense/krope", "cache/ckv", "cache/krope",
        "length"}
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        assert got[k].dtype == np.asarray(want[k]).dtype, k
    assert model.init_state(1, 64, window=8, device="cpu")["cache"][
        "ckv"].shape[2] == 64


def test_decode_from_a_jax_state():
    """A JAX-prefilled MLA state carried over with ``state_from_jax``:
    both packages decode on from it to the same logits and latent slots."""
    jmodel, jp, model, params = _pair()
    B, S = 2, 12
    toks = np.random.default_rng(5).integers(
        0, jmodel.config.vocab_size, (B, S + 3)).astype(np.int32)
    _, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                               jmodel.init_state(B, 24))
    state = state_from_jax(jstate, "cpu")
    assert set(state) == {"cache_dense", "cache", "length"}
    for t in range(3):
        jl, jstate = jmodel.decode(jp, jnp.asarray(toks[:, S + t]), jstate)
        tl, state = model.decode(params, torch.from_numpy(toks[:, S + t]),
                                 state)
        assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    got = to_flat(flatten(state))
    for k, v in _flatten(jstate).items():
        assert_allclose(got[k], np.asarray(v), **UNIT)


def test_mla_does_not_page():
    """JAX's ``supports_paging`` is false for MLA; the port's paged state
    and ``PagedInferenceEngine`` refuse it with JAX's messages."""
    jcfg, tcfg = _cfgs()
    assert not jpaged.supports_paging(jcfg)
    assert not paged.supports_paging(tcfg)
    with pytest.raises(ValueError) as want:
        jpaged.init_paged_state(jcfg, 2, 9, 4, 4)
    with pytest.raises(ValueError) as got:
        paged.init_paged_state(tcfg, 2, 9, 4, 4, device="cpu")
    assert str(got.value) == str(want.value)
    model = build_model(tcfg)
    with pytest.raises(ValueError, match="no paged KV path for family "
                                         "moe/mla"):
        PagedInferenceEngine(model, model.init(0, "cpu"), max_len=32,
                             page_size=16)
