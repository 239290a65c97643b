"""The port's MoE layer and the moe family's transformer (qwen3-moe-235b-a22b,
deepseek-v3-671b) against the JAX package's, on the CPU.

Same numpy inputs and the same weights (JAX init, carried over with
``params.from_jax``).  ``moe_block`` is held on the reduced configs and on
wider ones (8 experts top-2, 16 experts top-4 with a shared expert), fp32
and bf16: the routing (top-k ids, which assignments are kept, the
capacity C) must be equal, not close; y within 2e-5 (fp32) or 2e-2 x
(max|y| + 1) (bf16, the bound of tests/test_decode_consistency.py: each
bf16 product rounds, and a sum of k such terms that cancels keeps their
rounding); the Switch aux loss within 1e-6.  Cases: T <= 128 tokens
(dropless), T > 128 with a router skewed so that assignments drop, and
exact ties (a zeroed router: every probability 1/E, so ``jax.lax.top_k``'s
lower-index-first order decides).  The models: init keys and shapes,
forward/prefill/decode logits at 1e-4, paged prefill and decode bit for
bit the dense ones, and the verify windows against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models import paged as jpaged
from repro.models import transformer as jtransformer
from repro.training.checkpoint import _flatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, moe, paged, transformer
from repro_torch.params import flatten, from_jax, to_flat, unflatten


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
QWEN, DSV3 = "qwen3-moe-235b-a22b", "deepseek-v3-671b"
MOE_ARCHS = [QWEN, DSV3]

# (reduced arch, MoEConfig changes): the reduced configs (4 experts top-2;
# deepseek with its shared expert) and two wider ones
VARIANTS = {"qwen3": (QWEN, {}), "deepseek": (DSV3, {}),
            "e8k2": (QWEN, dict(num_experts=8, top_k=2)),
            "e16k4-shared": (DSV3, dict(num_experts=16, top_k=4))}


def _cfgs(arch, moe_changes=None, **changes):
    """The reduced config in both packages, with the same changes."""
    out = []
    for get, reduce in ((jget_config, jreduce),
                        (get_config, reduce_for_smoke)):
        cfg = reduce(get(arch))
        if moe_changes:
            changes = {**changes, "moe": dataclasses.replace(
                cfg.moe, **moe_changes)}
        out.append(dataclasses.replace(cfg, **changes))
    return out


def _t(tree):
    """Nested numpy/jax leaves -> torch tensors (same nesting)."""
    return unflatten(from_jax({k: np.asarray(v) for k, v in
                               _flatten(tree).items()}, "cpu"))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


# --- units: capacity, positions -------------------------------------------


@pytest.mark.parametrize("T", [1, 8, 127, 128, 129, 200, 256, 1000, 2048,
                               4096, 8192])
@pytest.mark.parametrize("k,E", [(2, 4), (8, 128), (8, 256), (4, 16)])
def test_capacity_for_matches_jax(T, k, E):
    assert moe.capacity_for(T, k, E) == jmoe.capacity_for(T, k, E)
    assert moe.capacity_for(T, k, E, 2.0) == jmoe.capacity_for(T, k, E, 2.0)


def test_capacity_edges():
    """Dropless up to 128 tokens; then a multiple of 8, at least 8: the
    phase-9 prefill of qwen3-moe (B=8, S=256) gets C = 160."""
    assert moe.capacity_for(128, 8, 128) == 128
    assert moe.capacity_for(129, 8, 128) == 16
    assert moe.capacity_for(129, 1, 256) == 8
    assert moe.capacity_for(2048, 8, 128) == 160
    assert moe.capacity_for(2048, 8, 256) == 80


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=1, max_size=60))
def test_positions_in_expert_property(ids):
    """Rank within the expert in flat order: equal to JAX's, and every
    expert's positions are 0..count-1 in the order its assignments come."""
    e = np.asarray(ids, np.int32)
    got = moe._positions_in_expert(torch.from_numpy(e), 7).numpy()
    want = np.asarray(jmoe._positions_in_expert(jnp.asarray(e), 7))
    np.testing.assert_array_equal(got, want)
    for x in range(7):
        np.testing.assert_array_equal(got[e == x],
                                      np.arange(int((e == x).sum())))


# --- units: moe_block ---------------------------------------------------------


def _inputs(case, T, D, E, seed=0):
    """x (T, D) and router changes: 'skew' makes expert 0 (then 1) every
    token's first choice so that assignments past C drop; 'ties' zeroes
    the router, every probability exactly 1/E."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((T, D)).astype(np.float32)
    router = None
    if case == "skew":
        x = x + 1.0
        router = (r.standard_normal((D, E)) * 0.02).astype(np.float32)
        router[:, 0] += 0.05
        router[:, 1] += 0.03
    elif case == "ties":
        router = np.zeros((D, E), np.float32)
    return x, router


def _jax_routing(p, x2, cfg):
    """The routing half of JAX's moe_block, step for step."""
    m = cfg.moe
    T = x2.shape[0]
    probs = jax.nn.softmax(x2.astype(jnp.float32) @ p["router"], axis=-1)
    top_p, top_i = jax.lax.top_k(probs, m.top_k)
    pos = jmoe._positions_in_expert(top_i.reshape(-1), m.num_experts)
    C = jmoe.capacity_for(T, m.top_k, m.num_experts)
    return np.asarray(top_i), np.asarray(pos < C), C


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,B,S", [("dropless", 2, 20), ("skew", 4, 64),
                                      ("ties", 2, 20), ("ties", 4, 64)])
def test_moe_block_matches_jax(variant, dtype, case, B, S):
    arch, changes = VARIANTS[variant]
    jcfg, tcfg = _cfgs(arch, changes, dtype=dtype)
    m = jcfg.moe
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    x, router = _inputs(case, B * S, jcfg.d_model, m.num_experts)
    if router is not None:
        jp = {**jp, "router": jnp.asarray(router)}
    jx = jnp.asarray(x).astype(jp["we_gate"].dtype).reshape(
        B, S, jcfg.d_model)
    tp = _t(jp)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        tp["we_gate"].dtype)
    assert ("ws_gate" in tp) == bool(m.num_shared_experts)

    want_i, want_keep, want_c = _jax_routing(jp, jx.reshape(-1, jcfg.d_model),
                                             jcfg)
    r = moe.route(tp, tx.reshape(-1, tcfg.d_model), tcfg)
    np.testing.assert_array_equal(r.top_i.numpy(), want_i)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    assert r.capacity == want_c
    dropped = int((~want_keep).sum())
    if case == "skew":
        assert dropped > 0
    if B * S <= 128:
        assert dropped == 0 and want_c == B * S
    if case == "ties":     # lower index first: experts 0..k-1 for everyone
        assert (want_i == np.arange(m.top_k)).all()

    jy, jaux = jmoe.moe_block(jp, jx, jcfg)
    ty, taux = moe.moe_block(tp, tx, tcfg)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    if dtype == "float32":
        assert_allclose(_np(ty), _np(jy), **UNIT)
    else:      # bf16 rounds each product: 2e-2 of the output's scale
        bound = 2e-2 * (float(np.abs(_np(jy)).max()) + 1.0)
        assert float(np.abs(_np(ty) - _np(jy)).max()) < bound
    assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


def test_moe_block_drop_slot_is_zero():
    """A dropped assignment contributes nothing: with every token routed
    to experts 0 and 1 (a zeroed router, T > 128), only the first C
    tokens get any routed output."""
    _, tcfg = _cfgs(QWEN)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, tcfg)
    p["router"].zero_()
    T = 200
    x = torch.randn((T, tcfg.d_model), generator=gen)
    r = moe.route(p, x, tcfg)
    C = r.capacity
    assert C == moe.capacity_for(T, 2, 4) < T
    y, _ = moe.moe_block(p, x, tcfg)
    assert torch.count_nonzero(y[C:]) == 0
    assert bool((y[:C].abs().sum(-1) > 0).all())


# --- the models ---------------------------------------------------------------


def _pair(arch, **changes):
    """(jax model, jax params, port model, port params), reduced."""
    jcfg, tcfg = _cfgs(arch, **changes)
    jmodel = jbuild_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jp, build_model(tcfg), from_jax(_flatten(jp), "cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_jax_keys_shapes_dtypes(arch, dtype):
    """``init_params``: the JAX keys, shapes and dtypes, ``dense_layers``,
    ``layers/moe/*`` and deepseek's ``mtp/{proj,layer,norm_h,norm_e}``
    included; ``Model.like()`` gives the same on the meta device."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    shapes = jax.eval_shape(lambda: jbuild_model(jcfg).init(
        jax.random.PRNGKey(0)))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(tcfg)
    for got in (model.init(0, "cpu"), model.like()):
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == tuple(want[k].shape), k
            assert str(v.dtype).removeprefix("torch.") == str(
                want[k].dtype), k
    assert all(v.device.type == "meta" for v in model.like().values())
    keys = set(want)
    assert "layers/moe/router" in keys and "layers/moe/we_gate" in keys
    if arch == DSV3:
        assert {"dense_layers/mlp/w_gate", "layers/moe/ws_gate",
                "mtp/proj", "mtp/layer/moe/we_up", "mtp/norm_h/scale",
                "mtp/norm_e/scale", "layers/attn/kv_b"} <= keys


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_match_jax(arch):
    jmodel, jp, model, params = _pair(arch)
    V = jmodel.config.vocab_size
    tokens = _tokens(V, (2, 24), 1)
    want = jmodel.forward(jp, {"tokens": jnp.asarray(tokens)})
    got = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 24, V)
    assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_matches_jax(arch):
    """Ragged prefill, then decode steps feeding each row its next token;
    logits at 1e-4, greedy streams identical, valid cache slots equal."""
    jmodel, jp, model, params = _pair(arch)
    V = jmodel.config.vocab_size
    B, S, steps = 3, 20, 6
    toks = _tokens(V, (B, S), 3)
    lens = np.array([20, 9, 14], np.int32)
    jstate = jmodel.init_state(B, 40)
    state = model.init_state(B, 40, device="cpu")
    jl, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(toks),
                                     "lengths": jnp.asarray(lens)}, jstate)
    tl, state = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                       "lengths": torch.from_numpy(lens)},
                              state)
    assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    for _ in range(steps):
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jstate = jmodel.decode(jp, jnp.asarray(jtok), jstate)
        tl, state = model.decode(params, ttok, state)
        assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    got = to_flat(flatten(state))
    want = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
    assert set(got) == set(want)
    for key in got:
        if key == "length":
            np.testing.assert_array_equal(got[key], want[key])
            continue
        for b in range(B):
            n = lens[b] + steps
            assert_allclose(got[key][:, b, :n], want[key][:, b, :n], **UNIT)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_padding_routes_as_jax(arch):
    """T > 128: a 3 x 64 bucket with ragged rows routes its padded
    positions too, so capacity binds across rows (zeroed routers: every
    token to experts 0 and 1, C = 64 of 192); the port's logits still
    equal JAX's, so padding takes capacity in the same order."""
    jmodel, jp, model, params = _pair(arch)
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    for k in flat:
        if k.endswith("moe/router"):
            flat[k] = np.zeros_like(flat[k])
    jp = jax.tree_util.tree_map(jnp.asarray, unflatten(flat))
    params = from_jax(flat, "cpu")
    V = jmodel.config.vocab_size
    toks = _tokens(V, (3, 64), 8)
    lens = np.array([64, 30, 47], np.int32)
    assert moe.capacity_for(3 * 64, 2, 4) < 3 * 64
    jl, _ = jmodel.prefill(jp, {"tokens": jnp.asarray(toks),
                                "lengths": jnp.asarray(lens)},
                           jmodel.init_state(3, 80))
    tl, _ = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.from_numpy(lens)},
                          model.init_state(3, 80, device="cpu"))
    assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)


def test_paged_prefill_decode_bitwise_dense():
    """qwen3-moe: the paged path is bit for bit the dense one (the JAX
    test_paged_prefill_decode_matches_dense, for the moe family): prefill
    logits, then every decode step through the page table; both within
    1e-4 of JAX's paged path."""
    jmodel, jp, model, params = _pair(QWEN)
    cfg, jcfg = model.config, jmodel.config
    assert paged.supports_paging(cfg) and jpaged.supports_paging(jcfg)
    B, S, steps, ps = 2, 12, 3, 4
    toks = _tokens(cfg.vocab_size, (B, S + steps), 3)
    MP = -(-(S + steps) // ps)
    table = np.asarray([[1 + b * MP + j for j in range(MP)]
                        for b in range(B)], np.int32)
    nc = -(-S // ps)
    lengths = np.full((B,), S, np.int32)
    pstate = paged.init_paged_state(cfg, B, B * MP + 1, ps, MP,
                                    device="cpu")
    logits, pstate = paged.paged_prefill(
        params, torch.from_numpy(toks[:, :S]), torch.from_numpy(lengths),
        pstate, torch.zeros((B, 0), dtype=torch.int32),
        torch.zeros((B,), dtype=torch.int32),
        torch.from_numpy(table[:, :nc]), cfg, page_size=ps)
    pstate = {**pstate, "page_table": torch.from_numpy(table),
              "length": torch.from_numpy(lengths)}
    jstate = jpaged.init_paged_state(jcfg, B, B * MP + 1, ps, MP)
    jl, jstate = jpaged.paged_prefill(
        jp, jnp.asarray(toks[:, :S]), jnp.asarray(lengths), jstate,
        jnp.zeros((B, 0), jnp.int32), jnp.zeros((B,), jnp.int32),
        jnp.asarray(table[:, :nc]), jcfg, page_size=ps)
    jstate = {**jstate, "page_table": jnp.asarray(table),
              "length": jnp.asarray(lengths)}
    dl, dstate = model.prefill(params, {
        "tokens": torch.from_numpy(toks[:, :S]),
        "lengths": torch.from_numpy(lengths)},
        model.init_state(B, MP * ps, device="cpu"))
    assert torch.equal(logits, dl)
    assert_allclose(logits.numpy(), np.asarray(jl), **LOGITS)
    for t in range(steps):
        tok = torch.from_numpy(toks[:, S + t])
        logits, pstate = paged.paged_decode_step(params, tok, pstate, cfg,
                                                 page_size=ps)
        dl, dstate = model.decode(params, tok, dstate)
        jl, jstate = jpaged.paged_decode_step(
            jp, jnp.asarray(toks[:, S + t]), jstate, jcfg, page_size=ps)
        assert torch.equal(logits, dl)
        assert_allclose(logits.numpy(), np.asarray(jl), **LOGITS)


def test_paged_state_keys_match_jax():
    """A moe config with first dense layers gets a ``cache_dense`` pool
    (deepseek's dense/moe split with GQA attention, as JAX pages it)."""
    jcfg, tcfg = _cfgs(DSV3, attn_kind="gqa", mla=None)
    want = _flatten(jpaged.init_paged_state(jcfg, 3, 9, 4, 4))
    got = to_flat(flatten(paged.init_paged_state(tcfg, 3, 9, 4, 4,
                                                 device="cpu")))
    assert set(got) == set(want) >= {"cache_dense/k", "cache/k"}
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        assert got[k].dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("arch,changes", [
    (QWEN, {}), (DSV3, dict(attn_kind="gqa", mla=None))])
def test_verify_steps_match_jax(arch, changes):
    """``verify_decode_step`` (direct calls: the speculative engine takes
    dense GQA only) and ``paged_verify_step`` on the moe branch, against
    JAX's: the window's logits at 1e-4, the written K/V, and the state's
    length untouched."""
    jmodel, jp, model, params = _pair(arch, **changes)
    cfg, jcfg = model.config, jmodel.config
    B, S, W, ps = 2, 10, 3, 4
    toks = _tokens(cfg.vocab_size, (B, S + W), 6)
    lens = np.array([10, 7], np.int32)
    jstate = jmodel.init_state(B, 16)
    _, jstate = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                                    "lengths": jnp.asarray(lens)}, jstate)
    state = model.init_state(B, 16, device="cpu")
    _, state = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :S]),
                                      "lengths": torch.from_numpy(lens)},
                             state)
    window = toks[:, S:]
    jl, jstate = jtransformer.verify_decode_step(jp, jnp.asarray(window),
                                                 jstate, jcfg)
    tl, state = transformer.verify_decode_step(
        params, torch.from_numpy(window), state, cfg)
    assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert state["length"].tolist() == lens.tolist()
    got = to_flat(flatten(state))
    for key, want in _flatten(jstate).items():
        if key == "length":
            continue
        for b in range(B):
            n = lens[b] + W
            assert_allclose(got[key][:, b, :n], np.asarray(want)[:, b, :n],
                            **UNIT)

    # the paged window over a fresh page pool (table in row order)
    MP = 16 // ps
    table = np.asarray([[1 + b * MP + j for j in range(MP)]
                        for b in range(B)], np.int32)
    nc = -(-S // ps)
    pstate = paged.init_paged_state(cfg, B, B * MP + 1, ps, MP,
                                    device="cpu")
    jps = jpaged.init_paged_state(jcfg, B, B * MP + 1, ps, MP)
    args = (np.zeros((B, 0), np.int32), np.zeros((B,), np.int32),
            table[:, :nc])
    _, pstate = paged.paged_prefill(
        params, torch.from_numpy(toks[:, :S]), torch.from_numpy(lens),
        pstate, *map(torch.from_numpy, args), cfg, page_size=ps)
    _, jps = jpaged.paged_prefill(jp, jnp.asarray(toks[:, :S]),
                                  jnp.asarray(lens), jps,
                                  *map(jnp.asarray, args), jcfg,
                                  page_size=ps)
    pstate = {**pstate, "page_table": torch.from_numpy(table),
              "length": torch.from_numpy(lens)}
    jps = {**jps, "page_table": jnp.asarray(table),
           "length": jnp.asarray(lens)}
    pl, pstate = paged.paged_verify_step(params, torch.from_numpy(window),
                                         pstate, cfg, page_size=ps)
    jpl, _ = jpaged.paged_verify_step(jp, jnp.asarray(window), jps, jcfg,
                                      page_size=ps)
    assert_allclose(pl.numpy(), np.asarray(jpl), **LOGITS)
    assert_allclose(pl.numpy(), tl.numpy(), **LOGITS)
    assert pstate["length"].tolist() == lens.tolist()


def test_verify_refuses_mla():
    _, _, model, params = _pair(DSV3)
    state = model.init_state(1, 8, device="cpu")
    with pytest.raises(ValueError, match="gqa cache"):
        transformer.verify_decode_step(
            params, torch.zeros((1, 2), dtype=torch.int32), state,
            model.config)
