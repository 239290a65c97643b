"""The port's decode path (cache ops, ``init_state``, ``prefill``,
``decode_step``) against the JAX package's, on the CPU.

Same weights (JAX init carried over with ``params.from_jax``) and the same
numpy token ids through both packages at reduced fp32 sizes.  Logits are
compared at 1e-4 (two layers of fp32 matmuls, norms and softmax summed in
another order drift by a few 1e-6 per op), cache contents and units at
2e-5.  Only valid cache positions are compared after a ragged prefill: a
padded query past its row's length gets zeros from the port's flash
kernel and a uniform average from the JAX prefill's masked softmax, so
the K/V that later layers write at padded positions differ (nothing reads
them: a row's next token overwrites its first padded slot).
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
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.params import flatten, from_jax, state_from_jax, to_flat


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


def _pair(arch, **changes):
    """(jax model, jax params, port model, port params) at reduced size."""
    jcfg = dataclasses.replace(jreduce(jget_config(arch)), **changes)
    tcfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **changes)
    jmodel = jbuild_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jp, build_model(tcfg), from_jax(_flatten(jp), "cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, **tol):
    assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_decode_matches_jax(arch):
    """Ragged prefill, then decode steps feeding each row its next token
    (tests/test_decode_consistency.py, held to the JAX package)."""
    jmodel, jp, model, params = _pair(arch)
    V = jmodel.config.vocab_size
    B, S, steps = 3, 20, 6
    toks = _tokens(V, (B, S + steps), 3)
    lens = np.array([20, 9, 14], np.int32)
    jstate = jmodel.init_state(B, 40)
    state = model.init_state(B, 40, device="cpu")
    jl, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                                     "lengths": jnp.asarray(lens)}, jstate)
    tl, state = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]),
                                       "lengths": torch.from_numpy(lens)},
                              state)
    _close(tl, jl, **LOGITS)
    assert state["length"].dtype == torch.int32
    for t in range(steps):
        tok = toks[np.arange(B), lens + t]
        jl, jstate = jmodel.decode(jp, jnp.asarray(tok), jstate)
        tl, state = model.decode(params, torch.from_numpy(tok), state)
        _close(tl, jl, **LOGITS)
        np.testing.assert_array_equal(state["length"].numpy(),
                                      np.asarray(jstate["length"]))
    # valid positions of the cache (non-ring archs: every written slot)
    if jmodel.config.sliding_window is None:
        got = to_flat(flatten(state))
        want = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
        for key in ("cache/k", "cache/v"):
            for b in range(B):
                n = lens[b] + steps
                assert_allclose(got[key][:, b, :n], want[key][:, b, :n],
                                **UNIT)


def test_decode_from_a_jax_state():
    """Both packages decode on from one JAX-prefilled state, carried over
    with ``state_from_jax``: the logits and the written slots agree."""
    jmodel, jp, model, params = _pair("yi-9b")
    B, S = 2, 12
    toks = _tokens(jmodel.config.vocab_size, (B, S + 3), 5)
    _, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                               jmodel.init_state(B, 24))
    state = state_from_jax(jstate, "cpu")
    assert state["cache"]["k"].dtype == torch.float32
    assert state["length"].dtype == torch.int32
    for t in range(3):
        jl, jstate = jmodel.decode(jp, jnp.asarray(toks[:, S + t]), jstate)
        tl, state = model.decode(params, torch.from_numpy(toks[:, S + t]),
                                 state)
        _close(tl, jl, **LOGITS)
    for key in ("k", "v"):
        _close(state["cache"][key], jstate["cache"][key], **UNIT)


def test_state_from_jax_keeps_bf16_and_int32():
    jmodel, _, _, _ = _pair("h2o-danube-1.8b", dtype="bfloat16")
    jstate = jmodel.init_state(2, 64)
    jstate = {**jstate, "length": jnp.asarray([3, 7], jnp.int32)}
    state = state_from_jax(jstate, "cpu")
    assert state["cache"]["k"].dtype == torch.bfloat16
    assert tuple(state["cache"]["k"].shape) == jstate["cache"]["k"].shape
    assert state["length"].tolist() == [3, 7]


@pytest.mark.parametrize("arch,dtype", [("yi-9b", "float32"),
                                        ("h2o-danube-1.8b", "bfloat16"),
                                        ("command-r-plus-104b", "float32")])
def test_init_state_matches_jax(arch, dtype):
    """Keys, shapes and dtypes; danube's cache is a ring of the window."""
    jmodel, _, model, _ = _pair(arch, dtype=dtype)
    jstate = jmodel.init_state(3, 64)
    state = model.init_state(3, 64, device="cpu")
    want = {k: v for k, v in _flatten(jstate).items()}
    got = to_flat(flatten(state))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert not got[k].any()
    w = model.config.sliding_window
    assert state["cache"]["k"].shape[2] == (64 if w is None else w)
    assert model.init_state(1, 64, window=8, device="cpu")["cache"][
        "k"].shape[2] == 8


def test_danube_ring_wrap_matches_jax():
    """tests/test_ring_cache.py: a ring of the window's 16 slots wraps
    during prefill (25 tokens) and keeps wrapping while decoding; the port
    follows JAX step for step and its own windowed full forward."""
    jmodel, jp, model, params = _pair("h2o-danube-1.8b")
    B, S, extra = 2, 25, 5
    toks = _tokens(jmodel.config.vocab_size, (B, S + extra), 1)
    full = model.forward(params, {"tokens": torch.from_numpy(toks)})
    jstate = jmodel.init_state(B, 64)
    state = model.init_state(B, 64, device="cpu")
    assert state["cache"]["k"].shape[2] == model.config.sliding_window
    lens = np.full((B,), S, np.int32)
    jl, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                                     "lengths": jnp.asarray(lens)}, jstate)
    tl, state = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]),
                                       "lengths": torch.from_numpy(lens)},
                              state)
    _close(tl, jl, **LOGITS)
    errs = [float((tl - full[:, S - 1]).abs().max())]
    for t in range(extra):
        jl, jstate = jmodel.decode(jp, jnp.asarray(toks[:, S + t]), jstate)
        tl, state = model.decode(params, torch.from_numpy(toks[:, S + t]),
                                 state)
        _close(tl, jl, **LOGITS)
        errs.append(float((tl - full[:, S + t]).abs().max()))
    assert max(errs) < 1e-3, errs
    for key in ("k", "v"):
        _close(state["cache"][key], jstate["cache"][key], **UNIT)


def test_write_at_max_len_boundary_is_dropped():
    """A decode step whose position is past the cache's end leaves the
    cache as it was (JAX drops the out-of-range scatter), while the other
    rows write; logits and caches stay with JAX."""
    jmodel, jp, model, params = _pair("yi-9b")
    B, Smax = 2, 10
    toks = _tokens(jmodel.config.vocab_size, (B, Smax + 2), 7)
    lens = np.array([Smax, 4], np.int32)
    jstate = jmodel.init_state(B, Smax)
    state = model.init_state(B, Smax, device="cpu")
    jl, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :Smax]),
                                     "lengths": jnp.asarray(lens)}, jstate)
    tl, state = model.prefill(
        params, {"tokens": torch.from_numpy(toks[:, :Smax]),
                 "lengths": torch.from_numpy(lens)}, state)
    before = state["cache"]["k"][:, 0].clone()
    for t in range(2):                 # row 0 writes at Smax, then Smax + 1
        tok = toks[:, Smax + t]
        jl, jstate = jmodel.decode(jp, jnp.asarray(tok), jstate)
        tl, state = model.decode(params, torch.from_numpy(tok), state)
        _close(tl, jl, **LOGITS)
    assert torch.equal(state["cache"]["k"][:, 0], before)
    _close(state["cache"]["k"][:, 1, :6], jstate["cache"]["k"][:, 1, :6],
           **UNIT)
    assert state["length"].tolist() == [Smax + 2, 6]


def test_cache_write_and_ring_ops_match_jax():
    rng = np.random.default_rng(0)
    B, Smax, K, hd = 3, 6, 2, 8
    ck, cv = (rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
              for _ in range(2))
    nk, nv = (rng.standard_normal((B, 1, K, hd)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([0, 5, 6], np.int32)     # 6 is past the end: dropped
    jk, jv = jattn.cache_write(*(jnp.asarray(x) for x in (ck, cv, nk, nv)),
                               jnp.asarray(lengths))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out = tattn.cache_write(tk, tv, torch.from_numpy(nk),
                            torch.from_numpy(nv), torch.from_numpy(lengths))
    assert out[0] is tk and out[1] is tv          # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    lengths = np.array([3, 13, 6], np.int32)
    jk, jv = jattn.ring_write(*(jnp.asarray(x) for x in (ck, cv, nk, nv)),
                              jnp.asarray(lengths), Smax)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tattn.ring_write(tk, tv, torch.from_numpy(nk), torch.from_numpy(nv),
                     torch.from_numpy(lengths), Smax)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        tattn.ring_lengths(torch.from_numpy(lengths), Smax).numpy(),
        np.asarray(jattn.ring_lengths(jnp.asarray(lengths), Smax)))

    full = rng.standard_normal((B, 20, K, hd)).astype(np.float32)
    for lens in ([20, 3, 11], [1, 6, 7]):
        lens = np.asarray(lens, np.int32)
        np.testing.assert_array_equal(
            tattn.ring_fill(torch.from_numpy(full), torch.from_numpy(lens),
                            Smax).numpy(),
            np.asarray(jattn.ring_fill(jnp.asarray(full), jnp.asarray(lens),
                                       Smax)))


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attn_block_matches_jax(window):
    """One block's single-token attention with its cache write, both cache
    modes (window 5 on a 6-slot cache: ring mode)."""
    jmodel, jp, _, params = _pair("yi-9b")
    cfg = jmodel.config
    tcfg = reduce_for_smoke(get_config("yi-9b"))
    lp = {k: np.array(v[0]) for k, v in jp["layers"]["attn"].items()}
    rng = np.random.default_rng(4)
    B, Smax = 2, 6 if window else 12
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, Smax, cfg.num_kv_heads,
                                   cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([3, 9], np.int32)
    jo, jk, jv = jattn.decode_attn_block(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lengths), cfg,
        window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    to, _, _ = tattn.decode_attn_block(
        {k: torch.from_numpy(v) for k, v in lp.items()}, torch.from_numpy(x),
        tk, tv, torch.from_numpy(lengths), tcfg, window=window)
    _close(to, jo, **UNIT)
    _close(tk, jk, **UNIT)
    _close(tv, jv, **UNIT)
