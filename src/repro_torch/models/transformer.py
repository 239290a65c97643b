"""Decoder-only transformer, families ``dense`` and ``moe``: the port of
``repro/models/transformer.py``.

Covers yi-9b, mistral-large-123b, command-r-plus-104b (LayerNorm, parallel
block, tied embeddings), h2o-danube-1.8b (native sliding window),
qwen3-moe (qk-norm + MoE) and deepseek-v3 (MLA + first-k-dense + MoE; its
MTP params are carried, as the JAX package's train loss uses them, but
not served).  The layers run as a Python loop over views of the stacked
``(L, ...)`` params, a stack at a time (``stacks``).

The decode path (``init_state``, ``prefill``, ``decode_step`` and the
speculative ``verify_decode_step``) is the port of the JAX module's second
half.  Its state is ``{"cache": {"k", "v"} (L, B, Smax, K, hd), "length":
(B,) int32}`` for GQA, with ``{"ckv", "krope"}`` (L, B, Smax, kvr|rope)
for MLA, and a ``cache_dense`` of the same kind for a moe config's first
dense layers; ``prefill`` and ``decode_step`` write the caches IN PLACE
(the JAX engine donates them) and return a new dict holding the same
tensors and the new lengths.  The ssm, hybrid, vlm and encdec families
live in ``rwkv6.py``, ``hybrid.py``, ``vlm.py`` and ``encdec.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import opt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, compute_dtype,
                                       dense_init, embed_init, generator,
                                       init_mlp, init_norm, stack_init)
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.params import flatten, unflatten


def check_family(cfg: ModelConfig) -> None:
    """This module serves the dense and moe families with GQA or MLA
    attention; ``build_model`` routes the other ported families elsewhere
    and refuses the rest."""
    if cfg.family not in ("dense", "moe") or cfg.attn_kind not in ("gqa",
                                                                   "mla"):
        raise ValueError(f"transformer.py serves families 'dense'/'moe' "
                         f"with gqa or mla attention, not "
                         f"{cfg.family!r}/{cfg.attn_kind!r} ({cfg.name})")


def stacks(cfg: ModelConfig):
    """The layer stacks in order, as (param prefix, state key, layers,
    moe): a dense config has one; a moe config its ``first_k_dense``
    dense layers (``dense_layers``, ``cache_dense``) before its MoE
    layers (``layers``, ``cache``)."""
    if cfg.moe is None:
        return [("layers", "cache", cfg.num_layers, False)]
    n_dense = cfg.moe.first_k_dense
    out = [("dense_layers", "cache_dense", n_dense, False)] if n_dense else []
    return out + [("layers", "cache", cfg.num_layers - n_dense, True)]


# ---------------------------------------------------------------------------
# Init: directly on the generator's device, one layer at a time
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig,
               moe: bool = False) -> Dict[str, torch.Tensor]:
    """One layer's params, flat-keyed (``attn/wq``, ``ln1/scale``, ...);
    a moe config's dense layers take ``moe.d_ff_dense``."""
    p = {"ln1": init_norm(cfg, gen.device),
         "attn": (attn.init_mla(gen, cfg) if cfg.attn_kind == "mla"
                  else attn.init_attention(gen, cfg))}
    if not cfg.parallel_block:
        p["ln2"] = init_norm(cfg, gen.device)
    if moe:
        p["moe"] = init_moe(gen, cfg)
    else:
        d_ff = cfg.d_ff
        if cfg.moe and cfg.moe.first_k_dense and cfg.moe.d_ff_dense:
            d_ff = cfg.moe.d_ff_dense
        p["mlp"] = init_mlp(gen, cfg, d_ff=d_ff)
    return flatten(p)


def init_params(seed: int, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """Random params on ``device`` from a seeded ``torch.Generator``;
    stacked layer tensors are filled a layer at a time (``stack_init``).
    The keys and shapes are the JAX ``init_params``'s, ``mtp/*`` (the
    multi-token-prediction head, carried but not served) included."""
    check_family(cfg)
    gen = generator(seed, device)
    dt = compute_dtype(cfg)
    params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)}
    params.update(flatten({"final_norm": init_norm(cfg, gen.device)}))
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    for prefix, _, n, moe in stacks(cfg):
        stacked = stack_init(gen, n, init_layer, cfg, moe)
        params.update({f"{prefix}/{k}": v for k, v in stacked.items()})
    if cfg.mtp:
        mtp = {"proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dt),
               "layer": stack_init(gen, 1, init_layer, cfg,
                                   cfg.moe is not None),
               "norm_h": init_norm(cfg, gen.device),
               "norm_e": init_norm(cfg, gen.device)}
        params.update(flatten(mtp, "mtp/"))
    return params


def subtree(params: Dict[str, torch.Tensor], prefix: str,
            layer: Optional[int] = None):
    """Nested dict of the params under ``prefix/``; with ``layer``, views of
    that layer of the stacked tensors."""
    n = len(prefix) + 1
    return unflatten({k[n:]: (v if layer is None else v[layer])
                      for k, v in params.items()
                      if k.startswith(prefix + "/")})


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


def _residual(cfg: ModelConfig, lp, x, h, attn_out):
    """The block around attention: parallel (x + attn + mlp(h)) or serial,
    with the MoE block in place of the MLP in a MoE layer."""
    if cfg.parallel_block:
        return x + attn_out + apply_mlp(lp["mlp"], h, cfg)
    x = x + attn_out
    h2 = apply_norm(lp["ln2"], x, cfg)
    if "moe" in lp:
        return x + moe_block(lp["moe"], h2, cfg)[0]
    return x + apply_mlp(lp["mlp"], h2, cfg)


def _layer_full(cfg: ModelConfig, window, x, lp, positions, kv_lengths):
    h = apply_norm(lp["ln1"], x, cfg)
    if cfg.attn_kind == "mla":
        attn_out = attn.mla_attention_block(lp["attn"], h, cfg,
                                            positions=positions,
                                            kv_lengths=kv_lengths)
    else:
        attn_out = attn.attention_block(lp["attn"], h, cfg,
                                        positions=positions, causal=True,
                                        window=window,
                                        kv_lengths=kv_lengths)
    return _residual(cfg, lp, x, h, attn_out)


def forward(params, tokens, cfg: ModelConfig, *, kv_lengths=None,
            window: Optional[int] = None):
    """tokens (B,S) -> logits (B,S,V). ``window`` overrides
    cfg.sliding_window (GQA only, as in the JAX package)."""
    check_family(cfg)
    B, S = tokens.shape
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None, :]
    for prefix, _, n, _ in stacks(cfg):
        for i in range(n):
            x = _layer_full(cfg, window, x, subtree(params, prefix, i),
                            positions, kv_lengths)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    return project_logits(params, h, cfg)


def project_logits(params, h, cfg: ModelConfig):
    head = params["head"] if "head" in params else params["embed"].T
    return h @ head


# ---------------------------------------------------------------------------
# Decode path: one token against a per-layer cache
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               window: Optional[int] = None, device=None) -> Dict[str, Any]:
    """A zeroed decode state on ``device``: a ``cache`` per layer stack
    (``cache_dense`` for a moe config's dense layers), ``{"k", "v"}`` for
    GQA, ``{"ckv", "krope"}`` for MLA.  With a sliding window (the
    config's, or ``window``) and ``ring_cache`` (the JAX package's default)
    a GQA cache is a ring of ``min(max_len, window)`` slots; without it a
    full ``max_len`` cache, the window a mask.  MLA caches never ring.  A
    GQA cache is float8_e4m3fn under ``kv_cache_f8`` for a bfloat16
    config (``attention.cache_dtype``); an MLA cache keeps the compute
    dtype."""
    check_family(cfg)
    window = window if window is not None else cfg.sliding_window
    mla = cfg.attn_kind == "mla"
    if window is not None and not mla and opt.enabled("ring_cache"):
        max_len = min(max_len, window)
    mk_cache = attn.init_mla_cache if mla else attn.init_kv_cache
    state: Dict[str, Any] = {}
    for _, key, n, _ in stacks(cfg):
        c = mk_cache(n, batch, max_len, cfg, dtype, device)
        state[key] = c
        length = c.pop("length")
    state["length"] = length
    return state


def _layer_decode(cfg: ModelConfig, window, x, lp, cache, i, lengths):
    """One block of the decode step; writes layer ``i`` of ``cache`` in
    place."""
    h = apply_norm(lp["ln1"], x, cfg)
    if cfg.attn_kind == "mla":
        attn_out, _, _ = attn.mla_decode_block(
            lp["attn"], h, cache["ckv"][i], cache["krope"][i], lengths, cfg)
    else:
        attn_out, _, _ = attn.decode_attn_block(
            lp["attn"], h, cache["k"][i], cache["v"][i], lengths, cfg,
            window=window)
    return _residual(cfg, lp, x, h, attn_out)


def decode_step(params, token, state, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B,) -> (logits (B,V), new state).  Appends one position; the
    cache is written in place."""
    window = window if window is not None else cfg.sliding_window
    lengths = state["length"]
    x = params["embed"][token.long()][:, None, :]            # (B,1,D)
    for prefix, key, n, _ in stacks(cfg):
        for i in range(n):
            x = _layer_decode(cfg, window, x, subtree(params, prefix, i),
                              state[key], i, lengths)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    logits = project_logits(params, h, cfg)[:, 0]
    return logits, {**state, "length": lengths + 1}


# ---------------------------------------------------------------------------
# Verify window (speculative decoding): W tokens against the cache, one pass
# ---------------------------------------------------------------------------


def window_write(cache, new, lengths):
    """Write a W-token window per row at positions ``lengths + i``, IN
    PLACE: cache (B, Smax, K, hd), new (B, W, K, hd), cast to the cache's
    dtype by ``attention.to_cache``.  Positions past the cache's end are
    dropped, as JAX drops an out-of-range scatter: they are aimed at the
    last slot with the value that slot ends up holding (the window's own
    write there, or its old contents), so duplicate indices all carry one
    value and nothing past the end lands anywhere."""
    B, Smax = cache.shape[:2]
    W = new.shape[1]
    rows = torch.arange(B, device=cache.device)[:, None]
    lengths = lengths.long()[:, None]
    slots = torch.clamp(lengths + torch.arange(W, device=cache.device),
                        max=Smax - 1)                          # (B, W)
    src = torch.clamp(slots - lengths, min=0)                  # window index
    dst = attn.raw(cache)
    vals = torch.where((lengths < Smax)[:, :, None, None],
                       attn.raw(attn.to_cache(new, cache.dtype))[rows, src],
                       dst[:, Smax - 1][:, None])
    dst[rows, slots] = vals


def _layer_verify(cfg: ModelConfig, window, x, lp, cache_k, cache_v,
                  lengths):
    """One block over a W-token verify window, x (B, W, D).  The K/V of all
    W positions is written first; query i then attends with
    ``lengths + i + 1`` valid keys, the state the sequential step i saw
    (later window positions are masked out).  Each query goes through the
    same ``attn.decode_attention`` call with the same (B, H, hd) shapes as
    the sequential step — K2 on CUDA — never a fused multi-query pass."""
    B, W, _ = x.shape
    h = apply_norm(lp["ln1"], x, cfg)
    positions = lengths[:, None] + torch.arange(W, device=x.device)[None, :]
    q, k, v = attn.project_qkv(lp["attn"], h, cfg, positions=positions)
    window_write(cache_k, k, lengths)
    window_write(cache_v, v, lengths)
    out = torch.stack([attn.decode_attention(q[:, i], cache_k, cache_v,
                                             lengths + i + 1, window=window)
                       for i in range(W)], dim=1)
    attn_out = attn._linear(out.reshape(B, W, cfg.num_heads * cfg.head_dim),
                            lp["attn"]["wo"], lp["attn"].get("bo"))
    return _residual(cfg, lp, x, h, attn_out)


def verify_decode_step(params, tokens, state, cfg: ModelConfig, *,
                       window: Optional[int] = None):
    """Speculative verify: tokens (B, W) -> (logits (B, W, V), state).

    Row [b, i] of the logits is the next-token distribution after
    consuming ``tokens[b, :i+1]`` — what ``decode_step`` emits when fed
    those tokens one at a time.  The K/V of every window position is
    written in place (accepted positions are thereby committed; rejected
    ones are masked out by the caller's accepted length).
    ``state["length"]`` is NOT advanced: the speculative step owns the
    accepted-length accounting.  Needs a non-ring GQA cache (the JAX
    function has no MLA branch either)."""
    if cfg.attn_kind != "gqa":
        raise ValueError(f"{cfg.name}: the verify window needs a gqa "
                         f"cache, not {cfg.attn_kind!r}")
    window = window if window is not None else cfg.sliding_window
    lengths = state["length"]
    x = params["embed"][tokens.long()]                       # (B, W, D)
    for prefix, key, n, _ in stacks(cfg):
        cache = state[key]
        for i in range(n):
            x = _layer_verify(cfg, window, x, subtree(params, prefix, i),
                              cache["k"][i], cache["v"][i], lengths)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    return project_logits(params, h, cfg), dict(state)


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also fills the cache
# ---------------------------------------------------------------------------


def prefill_rings(Smax: int, S: int, window: Optional[int]) -> bool:
    """Whether prefill fills a GQA cache of ``Smax`` slots as a ring (the
    last Smax positions): when the bucket overflows it or it is a sliding
    window's ring."""
    return Smax < S or (window is not None and Smax <= window)


def _layer_prefill(cfg: ModelConfig, window, x, lp, positions, lengths,
                   cache, i, ring):
    """One block of the prefill; fills layer ``i`` of ``cache`` in place
    (a ring keeps the last Smax positions)."""
    h = apply_norm(lp["ln1"], x, cfg)
    if cfg.attn_kind == "mla":
        attn_out, c_kv, k_rope = attn.mla_full(
            lp["attn"], h, cfg, positions=positions, kv_lengths=lengths)
        new = ((cache["ckv"][i], c_kv), (cache["krope"][i], k_rope))
    else:
        q, k, v = attn.project_qkv(lp["attn"], h, cfg, positions=positions)
        attn_out = attn.attend(lp["attn"], q, k, v, cfg, causal=True,
                               window=window, lengths=lengths)
        new = ((cache["k"][i], k), (cache["v"][i], v))
    for c, t in new:
        attn.fill_cache(c, t, lengths, ring)
    return _residual(cfg, lp, x, h, attn_out)


def prefill(params, tokens, state, cfg: ModelConfig, *, lengths=None,
            window: Optional[int] = None):
    """Process a (right-padded) prompt batch, filling the decode cache in
    place.  tokens (B,S); lengths (B,) valid lengths (default: all S).
    Returns (last-valid-position logits (B,V), new state).

    GQA attention runs through the flash kernel with ``lengths`` and
    ``window``, as the ensemble forward's does (the JAX prefill takes the
    materialised-scores path; the two differ only at padded query
    positions that see no valid key: a zero-length row, or a window past
    every valid key).  MLA runs its materialised block and fills the
    latent ``ckv``/``krope`` cache from the whole bucket."""
    B, S = tokens.shape
    window = window if window is not None else cfg.sliding_window
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    lengths = lengths.to(torch.int32)
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None, :]
    mla = cfg.attn_kind == "mla"
    for prefix, key, n, _ in stacks(cfg):
        cache = state[key]
        ring = not mla and prefill_rings(cache["k"].shape[2], S, window)
        for i in range(n):
            x = _layer_prefill(cfg, window, x, subtree(params, prefix, i),
                               positions, lengths, cache, i, ring)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    rows = torch.arange(B, device=h.device)
    h_last = h[rows, lengths.long() - 1]          # each row's last valid
    logits = project_logits(params, h_last, cfg)
    return logits, {**state, "length": lengths}
