"""The port's flag table (``repro_torch/opt.py``) against ``repro/opt.py``,
and the flags the port reads held to the JAX package's behaviour.

Table: the same names, defaults, ``parse`` results and errors, and the
same thread-local state.  ``pallas_attn`` and ``pallas_paged_decode``
change no result of the port (the tensor's device chooses the kernel).
An engine built under ``kv_cache_f8`` makes fp8 states from any thread.

``ring_cache`` and ``attn_dtype``, after tests/test_ring_cache.py:33-52:
with ``ring_cache`` off a sliding-window cache is full-length in both
packages (dense, hybrid, vlm), and danube's prefill and decode through it
equal JAX's at 1e-4 (fp32 reduced config), past the window's wrap.  Under
each ``attn_dtype`` setting the plain attention paths (``gqa_attention``,
the plain one-token attention, MLA's decode) equal JAX's on the same
bfloat16 inputs at 1e-2 (outputs in bf16: one bf16 step), and the two
settings differ within bf16 noise (1e-2 of the output's scale, as the JAX
test allows).
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from conftest import smoke_model
from repro import opt as jopt
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.training.checkpoint import _flatten
from repro_torch import opt
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import InferenceEngine, PagedInferenceEngine
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import paged as tpaged
from repro_torch.params import from_jax


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


LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1e-2, atol=1e-2)


# --- the table --------------------------------------------------------------


def test_table_matches_jax():
    assert opt._DEFAULTS == jopt._DEFAULTS
    assert list(opt._DEFAULTS) == list(jopt._DEFAULTS)
    assert opt.all_flags() == jopt.all_flags()
    for name in jopt._DEFAULTS:
        assert opt.enabled(name) == jopt.enabled(name)
    assert opt.enabled("no_such_flag") is jopt.enabled("no_such_flag")


@pytest.mark.parametrize("spec", ["none", "all", "attn_dtype,ring_cache",
                                  "all,kv_cache_f8", " kv_cache_f8 , ,",
                                  "", "pallas_attn"])
def test_parse_matches_jax(spec):
    assert opt.parse(spec) == jopt.parse(spec)


@pytest.mark.parametrize("spec", ["nope", "attn_dtype,nope,zzz", "all,x"])
def test_parse_errors_match_jax(spec):
    with pytest.raises(KeyError) as te:
        opt.parse(spec)
    with pytest.raises(KeyError) as je:
        jopt.parse(spec)
    assert str(te.value) == str(je.value)


def test_set_flags_errors_and_flags_restore():
    with pytest.raises(KeyError) as te:
        opt.set_flags(kv_cache_f9=True)
    with pytest.raises(KeyError) as je:
        jopt.set_flags(kv_cache_f9=True)
    assert str(te.value) == str(je.value)
    with pytest.raises(RuntimeError):
        with opt.flags(kv_cache_f8=True, ring_cache=0):
            assert opt.enabled("kv_cache_f8") is True
            assert opt.enabled("ring_cache") is False
            raise RuntimeError
    assert opt.all_flags() == jopt.all_flags()


def test_flags_are_thread_local():
    seen = {}
    with opt.flags(kv_cache_f8=True):
        t = threading.Thread(target=lambda: seen.update(opt.all_flags()))
        t.start()
        t.join()
        assert opt.enabled("kv_cache_f8")
    assert seen == dict(jopt._DEFAULTS)


# --- flags that change nothing in the port -----------------------------------


@pytest.fixture(scope="module")
def yi():
    tcfg = reduce_for_smoke(get_config("yi-9b"))
    model = build_model(tcfg)
    return tcfg, model, model.init(0, "cpu")


def _prefill_decode(model, params, tokens, steps=2):
    state = model.init_state(2, 32, device="cpu")
    lg, state = model.prefill(params, {"tokens": tokens}, state)
    out = [lg]
    for t in range(steps):
        lg, state = model.decode(params, tokens[:, t], state)
        out.append(lg)
    return torch.stack(out)


def _paged_step(tcfg, params, tokens):
    state = tpaged.init_paged_state(tcfg, 2, 9, 16, 4, device="cpu")
    state["page_table"][0, :2] = torch.tensor([1, 2])
    state["page_table"][1, :2] = torch.tensor([3, 4])
    dest = state["page_table"][:, :1]
    lg, state = tpaged.paged_prefill(
        params, tokens, torch.full((2,), tokens.shape[1]), state,
        torch.zeros((2, 0), dtype=torch.int32), torch.zeros((2,)), dest,
        tcfg, page_size=16)
    state["length"] = torch.full((2,), tokens.shape[1], dtype=torch.int32)
    lg2, _ = tpaged.paged_decode_step(params, tokens[:, 0], state, tcfg,
                                      page_size=16)
    return torch.stack([lg, lg2])


def test_pallas_flags_change_no_result(yi):
    tcfg, model, params = yi
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int64))
    base = (model.forward(params, {"tokens": tokens}),
            _prefill_decode(model, params, tokens),
            _paged_step(tcfg, params, tokens))
    with opt.flags(pallas_attn=True, pallas_paged_decode=True):
        flagged = (model.forward(params, {"tokens": tokens}),
                   _prefill_decode(model, params, tokens),
                   _paged_step(tcfg, params, tokens))
    for a, b in zip(base, flagged):
        assert torch.equal(a, b)


def test_engine_allocates_under_its_build_flags():
    """The thread-local trap: an engine built under kv_cache_f8 makes fp8
    states from a thread that never set the flag (a scheduler's service
    thread), and one built without it never does."""
    tcfg = dataclasses.replace(reduce_for_smoke(get_config("yi-9b")),
                               dtype="bfloat16")
    model = build_model(tcfg)
    params = model.init(0, "cpu")
    with opt.flags(kv_cache_f8=True):
        f8 = (InferenceEngine(model, params, max_len=32, max_batch=2),
              PagedInferenceEngine(model, params, max_len=32, max_batch=2))
    plain = InferenceEngine(model, params, max_len=32, max_batch=2)
    got = {}

    def other_thread():
        got["f8"] = [e.new_state(2)["cache"]["k"].dtype for e in f8]
        got["plain"] = plain.new_state(2)["cache"]["k"].dtype

    t = threading.Thread(target=other_thread)
    t.start()
    t.join()
    assert got["f8"] == [torch.float8_e4m3fn] * 2
    assert got["plain"] == torch.bfloat16


# --- ring_cache --------------------------------------------------------------


@pytest.mark.parametrize("arch,key,axis,max_len,window", [
    ("h2o-danube-1.8b", ("cache", "k"), 2, 64, None),      # window 16
    ("zamba2-2.7b", ("shared_k",), 2, 128, None),          # shared 64
    ("llama-3.2-vision-11b", ("k",), 3, 64, 16)])
@pytest.mark.parametrize("ring", [True, False])
def test_ring_cache_flag_sets_cache_length_as_jax(arch, key, axis, max_len,
                                                  window, ring):
    jcfg = jreduce(jget_config(arch))
    tcfg = reduce_for_smoke(get_config(arch))
    kw = {} if window is None else {"window": window}
    with jopt.flags(ring_cache=ring):
        want = jbuild(jcfg).init_state(2, max_len, **kw)
    with opt.flags(ring_cache=ring):
        got = build_model(tcfg).init_state(2, max_len, device="meta", **kw)
    for k in key:
        want, got = want[k], got[k]
    assert tuple(got.shape) == want.shape
    assert (got.shape[axis] == max_len) is (not ring)


def test_ring_disabled_matches_jax_past_the_wrap():
    """danube (smoke window 16) through a full 64-slot cache with the
    window as a mask: prefill of 25 tokens and 3 decode steps equal the
    JAX package's under the same flag (and the ring's)."""
    cfg, jm, jp = smoke_model("h2o-danube-1.8b")
    tcfg = reduce_for_smoke(get_config("h2o-danube-1.8b"))
    tm, tp = build_model(tcfg), from_jax(_flatten(jp), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 28)).astype(np.int32)
    S = 25
    lens = np.full((2,), S, np.int32)
    with jopt.flags(ring_cache=False):
        jstate = jm.init_state(2, 64)
        prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)
        lg, jstate = prefill(jp, {"tokens": jnp.asarray(tokens[:, :S]),
                                  "lengths": jnp.asarray(lens)}, jstate)
        want = [np.asarray(lg)]
        for t in range(3):
            lg, jstate = decode(jp, jnp.asarray(tokens[:, S + t]), jstate)
            want.append(np.asarray(lg))
    with opt.flags(ring_cache=False):
        tstate = tm.init_state(2, 64, device="cpu")
    assert tstate["cache"]["k"].shape[2] == 64
    lg, tstate = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :S]),
                                 "lengths": torch.from_numpy(lens)}, tstate)
    got = [lg]
    for t in range(3):
        lg, tstate = tm.decode(tp, torch.from_numpy(tokens[:, S + t]),
                               tstate)
        got.append(lg)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), w, **LOGITS)
    ring = tm.init_state(2, 64, device="cpu")
    assert ring["cache"]["k"].shape[2] == tcfg.sliding_window
    lg, ring = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :S]),
                               "lengths": torch.from_numpy(lens)}, ring)
    for t in range(3):
        lg, ring = tm.decode(tp, torch.from_numpy(tokens[:, S + t]), ring)
    assert_allclose(lg.numpy(), got[-1].numpy(), **LOGITS)


# --- attn_dtype --------------------------------------------------------------


def _bf16(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32), np.float32)


@pytest.mark.parametrize("lowp", [True, False])
def test_plain_attention_paths_match_jax_under_attn_dtype(lowp):
    rng = np.random.default_rng(2)
    B, S, Smax, H, K, hd = 2, 7, 40, 8, 2, 32
    jq, tq = _bf16(rng, (B, H, hd))
    jk, tk = _bf16(rng, (B, Smax, K, hd))
    jv, tv = _bf16(rng, (B, Smax, K, hd))
    lens = np.array([40, 13], np.int32)
    jqs, tqs = _bf16(rng, (B, S, H, hd))
    mask = np.tril(np.ones((S, Smax), bool), k=Smax - S)[None, None]
    with jopt.flags(attn_dtype=lowp):
        ref = jax.jit(functools.partial(jattn.decode_attention_ref,
                                        window=20))
        want = (ref(jq, jk, jv, jnp.asarray(lens)),
                jax.jit(jattn.gqa_attention)(jqs, jk, jv, jnp.asarray(mask)))
    with opt.flags(attn_dtype=lowp):
        got = (decode_attention_plain(tq, tk, tv, torch.from_numpy(lens),
                                      window=20),
               tattn.gqa_attention(tqs, tk, tv, torch.from_numpy(mask)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert_allclose(_np(g), _np(w), **BF16)


@pytest.mark.parametrize("lowp", [True, False])
def test_mla_decode_matches_jax_under_attn_dtype(lowp):
    jcfg = dataclasses.replace(jreduce(jget_config("deepseek-v3-671b")),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(reduce_for_smoke(get_config(
        "deepseek-v3-671b")), dtype="bfloat16")
    jp = jattn.init_mla(jax.random.PRNGKey(3), jcfg)
    tp = from_jax(_flatten(jp), "cpu")
    rng = np.random.default_rng(3)
    B, Smax, m = 2, 24, jcfg.mla
    jx, tx = _bf16(rng, (B, 1, jcfg.d_model))
    jc, tc = _bf16(rng, (B, Smax, m.kv_lora_rank))
    jr, tr = _bf16(rng, (B, Smax, m.rope_head_dim))
    lens = np.array([5, 17], np.int32)
    with jopt.flags(attn_dtype=lowp):
        want, _, _ = jax.jit(functools.partial(
            jattn.mla_decode_block, cfg=jcfg))(jp, jx, jc, jr,
                                               jnp.asarray(lens))
    with opt.flags(attn_dtype=lowp):
        got, _, _ = tattn.mla_decode_block(tp, tx, tc, tr,
                                             torch.from_numpy(lens), tcfg)
    assert_allclose(_np(got), _np(want), **BF16)


def test_attn_dtype_flag_equivalence():
    """attn_dtype changes precision, not math (within bf16 noise): a bf16
    yi prefill and decode steps, both settings."""
    tcfg = dataclasses.replace(reduce_for_smoke(get_config("yi-9b")),
                               dtype="bfloat16")
    model = build_model(tcfg)
    params = model.init(0, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int64))
    with opt.flags(attn_dtype=True):
        a = _prefill_decode(model, params, tokens, steps=3).float()
    with opt.flags(attn_dtype=False):
        b = _prefill_decode(model, params, tokens, steps=3).float()
    scale = float(b.abs().max()) + 1.0
    assert float((a - b).abs().max()) < 1e-2 * scale
