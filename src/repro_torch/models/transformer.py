"""Decoder-only transformer, family ``dense``: the port of the full-sequence
half of ``repro/models/transformer.py``.

Covers yi-9b, mistral-large-123b, command-r-plus-104b (LayerNorm, parallel
block, tied embeddings) and h2o-danube-1.8b (native sliding window).  The
layers run as a Python loop over views of the stacked ``(L, ...)`` params.

The decode path (``init_state``, ``prefill``, ``decode_step`` and the
speculative ``verify_decode_step``) is the port of the JAX module's second
half.  Its state is ``{"cache": {"k", "v"}
(L, B, Smax, K, hd), "length": (B,) int32}``; ``prefill`` and
``decode_step`` write the cache IN PLACE (the JAX engine donates it) and
return a new dict holding the same cache tensors and the new lengths.
MoE and MLA come with later slices; the ssm and hybrid families live in
``rwkv6.py`` and ``hybrid.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, compute_dtype,
                                       dense_init, embed_init, generator,
                                       init_mlp, init_norm, stack_init)
from repro_torch.params import flatten, unflatten


def check_family(cfg: ModelConfig) -> None:
    """This module serves dense GQA configs; ``build_model`` routes the
    other ported families elsewhere and refuses the rest."""
    if cfg.family != "dense" or cfg.attn_kind != "gqa":
        raise ValueError(f"transformer.py serves family 'dense' with gqa "
                         f"attention, not {cfg.family!r}/{cfg.attn_kind!r} "
                         f"({cfg.name})")


# ---------------------------------------------------------------------------
# Init: directly on the generator's device, one layer at a time
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """One layer's params, flat-keyed (``attn/wq``, ``ln1/scale``, ...)."""
    p = {"ln1": init_norm(cfg, gen.device),
         "attn": attn.init_attention(gen, cfg)}
    if not cfg.parallel_block:
        p["ln2"] = init_norm(cfg, gen.device)
    p["mlp"] = init_mlp(gen, cfg)
    return flatten(p)


def init_params(seed: int, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """Random params on ``device`` from a seeded ``torch.Generator``;
    stacked layer tensors are filled a layer at a time (``stack_init``)."""
    check_family(cfg)
    gen = generator(seed, device)
    dt = compute_dtype(cfg)
    params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)}
    params.update(flatten({"final_norm": init_norm(cfg, gen.device)}))
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    stacked = stack_init(gen, cfg.num_layers, init_layer, cfg)
    params.update({f"layers/{k}": v for k, v in stacked.items()})
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
    """The block around attention: parallel (x + attn + mlp(h)) or serial."""
    if cfg.parallel_block:
        return x + attn_out + apply_mlp(lp["mlp"], h, cfg)
    x = x + attn_out
    h2 = apply_norm(lp["ln2"], x, cfg)
    return x + apply_mlp(lp["mlp"], h2, cfg)


def _layer_full(cfg: ModelConfig, window, x, lp, positions, kv_lengths):
    h = apply_norm(lp["ln1"], x, cfg)
    attn_out = attn.attention_block(lp["attn"], h, cfg, positions=positions,
                                    causal=True, window=window,
                                    kv_lengths=kv_lengths)
    return _residual(cfg, lp, x, h, attn_out)


def forward(params, tokens, cfg: ModelConfig, *, kv_lengths=None,
            window: Optional[int] = None):
    """tokens (B,S) -> logits (B,S,V). ``window`` overrides
    cfg.sliding_window."""
    check_family(cfg)
    B, S = tokens.shape
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None, :]
    for i in range(cfg.num_layers):
        x = _layer_full(cfg, window, x, subtree(params, "layers", i), positions,
                        kv_lengths)
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
    """A zeroed decode state on ``device``.  With a sliding window (the
    config's, or ``window``) the cache is a ring of ``min(max_len,
    window)`` slots: the JAX package's ``ring_cache`` default."""
    check_family(cfg)
    window = window if window is not None else cfg.sliding_window
    if window is not None:
        max_len = min(max_len, window)
    c = attn.init_kv_cache(cfg.num_layers, batch, max_len, cfg, dtype,
                           device)
    length = c.pop("length")
    return {"cache": c, "length": length}


def _layer_decode(cfg: ModelConfig, window, x, lp, cache_k, cache_v,
                  lengths):
    """One block of the decode step; writes this layer's cache in place."""
    h = apply_norm(lp["ln1"], x, cfg)
    attn_out, _, _ = attn.decode_attn_block(lp["attn"], h, cache_k, cache_v,
                                            lengths, cfg, window=window)
    return _residual(cfg, lp, x, h, attn_out)


def decode_step(params, token, state, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B,) -> (logits (B,V), new state).  Appends one position; the
    cache is written in place."""
    window = window if window is not None else cfg.sliding_window
    lengths = state["length"]
    cache = state["cache"]
    x = params["embed"][token.long()][:, None, :]            # (B,1,D)
    for i in range(cfg.num_layers):
        x = _layer_decode(cfg, window, x, subtree(params, "layers", i),
                          cache["k"][i], cache["v"][i], lengths)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    logits = project_logits(params, h, cfg)[:, 0]
    return logits, {**state, "length": lengths + 1}


# ---------------------------------------------------------------------------
# Verify window (speculative decoding): W tokens against the cache, one pass
# ---------------------------------------------------------------------------


def window_write(cache, new, lengths):
    """Write a W-token window per row at positions ``lengths + i``, IN
    PLACE: cache (B, Smax, K, hd), new (B, W, K, hd).  Positions past the
    cache's end are dropped, as JAX drops an out-of-range scatter: they are
    aimed at the last slot with the value that slot ends up holding (the
    window's own write there, or its old contents), so duplicate indices
    all carry one value and nothing past the end lands anywhere."""
    B, Smax = cache.shape[:2]
    W = new.shape[1]
    rows = torch.arange(B, device=cache.device)[:, None]
    lengths = lengths.long()[:, None]
    slots = torch.clamp(lengths + torch.arange(W, device=cache.device),
                        max=Smax - 1)                          # (B, W)
    src = torch.clamp(slots - lengths, min=0)                  # window index
    vals = torch.where((lengths < Smax)[:, :, None, None],
                       new[rows, src].to(cache.dtype),
                       cache[:, Smax - 1][:, None])
    cache[rows, slots] = vals


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
    accepted-length accounting.  Needs a non-ring cache."""
    window = window if window is not None else cfg.sliding_window
    lengths = state["length"]
    cache = state["cache"]
    x = params["embed"][tokens.long()]                       # (B, W, D)
    for i in range(cfg.num_layers):
        x = _layer_verify(cfg, window, x, subtree(params, "layers", i),
                          cache["k"][i], cache["v"][i], lengths)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    return project_logits(params, h, cfg), dict(state)


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also fills the cache
# ---------------------------------------------------------------------------


def prefill(params, tokens, state, cfg: ModelConfig, *, lengths=None,
            window: Optional[int] = None):
    """Process a (right-padded) prompt batch, filling the decode cache in
    place.  tokens (B,S); lengths (B,) valid lengths (default: all S).
    Returns (last-valid-position logits (B,V), new state).

    Attention runs through the flash kernel with ``lengths`` and
    ``window``, as the ensemble forward's does (the JAX prefill takes the
    materialised-scores path; the two differ only at padded query
    positions, which nothing reads)."""
    B, S = tokens.shape
    window = window if window is not None else cfg.sliding_window
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    lengths = lengths.to(torch.int32)
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None, :]
    ck_all, cv_all = state["cache"]["k"], state["cache"]["v"]
    Smax = ck_all.shape[2]
    ring = Smax < S or (window is not None and Smax <= window)
    H, hd = cfg.num_heads, cfg.head_dim
    for i in range(cfg.num_layers):
        lp = subtree(params, "layers", i)
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = attn.project_qkv(lp["attn"], h, cfg, positions=positions)
        out = attn.flash_attention(q, k, v, causal=True, window=window,
                                   lengths=lengths)
        attn_out = attn._linear(out.reshape(B, S, H * hd), lp["attn"]["wo"],
                                lp["attn"].get("bo"))
        for cache, new in ((ck_all[i], k), (cv_all[i], v)):
            if ring:     # keep only the last Smax positions, in ring order
                cache.copy_(attn.ring_fill(new, lengths, Smax))
            else:
                cache[:, :S].copy_(new)
                cache[:, S:].zero_()
        x = _residual(cfg, lp, x, h, attn_out)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    rows = torch.arange(B, device=h.device)
    h_last = h[rows, lengths.long() - 1]          # each row's last valid
    logits = project_logits(params, h_last, cfg)
    return logits, {**state, "length": lengths}
