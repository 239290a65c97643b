"""Decoder-only transformer, families ``dense`` and ``moe``: the port of
``repro/models/transformer.py``.

Covers yi-9b, mistral-large-123b, command-r-plus-104b (LayerNorm, parallel
block, tied embeddings), h2o-danube-1.8b (native sliding window),
qwen3-moe (qk-norm + MoE) and deepseek-v3 (MLA + first-k-dense + MoE; its
MTP params are used by ``train_loss`` only, as in the JAX package).  The
layers run as a Python loop over views of the stacked ``(L, ...)``
params, a stack at a time (``stacks``); under ``remat`` each layer runs
inside ``torch.utils.checkpoint``, the JAX scan body's ``jax.checkpoint``.

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

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import opt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (add_norm, apply_mlp, apply_norm,
                                       chunked_cross_entropy, compute_dtype,
                                       cross_entropy_loss, dense_init,
                                       embed_init, generator, init_mlp,
                                       init_norm, matmul, stack_init)
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


def subtree(params: Dict[str, torch.Tensor], prefix: str):
    """Nested dict of the params under ``prefix/``."""
    n = len(prefix) + 1
    return unflatten({k[n:]: v for k, v in params.items()
                      if k.startswith(prefix + "/")})


def layer_views(params: Dict[str, torch.Tensor],
                prefix: str) -> List[Dict[str, Any]]:
    """The layers of the stack under ``prefix/`` as nested dicts of views,
    one ``unbind`` per stacked tensor: its backward stacks the layers'
    gradients once (a view per ``v[i]`` would add a zero-filled copy of
    the whole stack per layer)."""
    n = len(prefix) + 1
    cols = {k[n:]: v.unbind(0) for k, v in params.items()
            if k.startswith(prefix + "/")}
    num = len(next(iter(cols.values())))
    return [unflatten({k: v[i] for k, v in cols.items()}) for i in range(num)]


def call_layer(fn, *args, remat: bool = False):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``remat`` (the
    JAX scan body's ``jax.checkpoint``): one layer of every family's
    training path."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def run_layers(fn, layers, x, *args, remat: bool = False):
    """x through ``fn(x, lp, *args) -> (x, aux or None)`` for each layer's
    params ``lp``, each call under ``call_layer``; returns (x, the sum of
    the aux losses, None if none)."""
    aux = None
    for lp in layers:
        x, a = call_layer(fn, x, lp, *args, remat=remat)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


def _residual(cfg: ModelConfig, lp, x, h, attn_out):
    """The block around attention: parallel (x + attn + mlp(h)) or serial,
    with the MoE block in place of the MLP in a MoE layer.  Returns (x, the
    MoE block's router aux loss, or None)."""
    if cfg.parallel_block:
        return x + attn_out + apply_mlp(lp["mlp"], h, cfg), None
    x, h2 = add_norm(lp["ln2"], x, attn_out, cfg)
    if "moe" in lp:
        mo, aux = moe_block(lp["moe"], h2, cfg)
        return x + mo, aux
    return x + apply_mlp(lp["mlp"], h2, cfg), None


def _layer_full(cfg: ModelConfig, window, x, lp, positions, kv_lengths):
    """One block over the full sequence: (x, aux or None)."""
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


def _stack(cfg: ModelConfig, layers, x, positions, kv_lengths, window,
           remat: bool):
    def body(x, lp):
        return _layer_full(cfg, window, x, lp, positions, kv_lengths)
    return run_layers(body, layers, x, remat=remat)


def hidden(params, tokens, cfg: ModelConfig, *, kv_lengths=None,
           window: Optional[int] = None, remat: bool = False):
    """tokens (B,S) -> (the final-normed hidden states (B,S,D), the summed
    MoE router aux loss)."""
    check_family(cfg)
    S = tokens.shape[1]
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for prefix, _, _, _ in stacks(cfg):
        x, a = _stack(cfg, layer_views(params, prefix), x, positions,
                      kv_lengths, window, remat)
        if a is not None:
            aux = aux + a
    return apply_norm(subtree(params, "final_norm"), x, cfg), aux


def forward(params, tokens, cfg: ModelConfig, *, kv_lengths=None,
            window: Optional[int] = None, remat: bool = False):
    """tokens (B,S) -> logits (B,S,V); ``hidden`` gives the final hidden
    states and the MoE aux loss (the JAX ``forward(return_hidden=True)``).
    ``window`` overrides cfg.sliding_window (GQA only, as in the JAX
    package)."""
    h, _ = hidden(params, tokens, cfg, kv_lengths=kv_lengths,
                  window=window, remat=remat)
    return project_logits(params, h, cfg)


def project_logits(params, h, cfg: ModelConfig):
    head = params["head"] if "head" in params else params["embed"].T
    return h @ head


# ---------------------------------------------------------------------------
# Train loss (with optional deepseek MTP)
# ---------------------------------------------------------------------------


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """batch {"tokens", "labels" (B,S), optional "mask"} -> (loss, metrics):
    the port of the JAX ``train_loss``.  Under ``chunked_ce`` with a vocab
    of at least 32768 the logits are never materialized; a moe config adds
    ``router_aux_weight`` x the router aux loss; deepseek's MTP head adds
    0.3 x its next-next-token loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("mask")
    h, aux = hidden(params, tokens, cfg, remat=remat)
    if opt.enabled("chunked_ce") and cfg.vocab_size >= 32768:
        head = params["head"] if "head" in params else params["embed"].T
        loss = chunked_cross_entropy(h, head, labels, mask)
    else:
        loss = cross_entropy_loss(project_logits(params, h, cfg), labels,
                                  mask)
    metrics = {"ce": loss, "aux": aux}
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    if cfg.mtp and any(k.startswith("mtp/") for k in params):
        mtp = subtree(params, "mtp")
        # predict t+2: combine h_t with the embedding of label t (token t+1)
        emb_next = params["embed"][labels.long()]
        hm = torch.cat([apply_norm(mtp["norm_h"], h, cfg),
                        apply_norm(mtp["norm_e"], emb_next, cfg)], -1)
        hm = matmul(hm, mtp["proj"])
        positions = torch.arange(tokens.shape[1], device=hm.device)[None, :]
        hm, _ = _stack(cfg, layer_views(params, "mtp/layer"), hm,
                       positions, None, cfg.sliding_window, remat)
        mtp_logits = project_logits(params, apply_norm(
            subtree(params, "final_norm"), hm, cfg), cfg)
        mtp_labels = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        mtp_loss = cross_entropy_loss(mtp_logits, mtp_labels, mask)
        metrics["mtp"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


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
    return _residual(cfg, lp, x, h, attn_out)[0]


def decode_step(params, token, state, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B,) -> (logits (B,V), new state).  Appends one position; the
    cache is written in place."""
    window = window if window is not None else cfg.sliding_window
    lengths = state["length"]
    x = params["embed"][token.long()][:, None, :]            # (B,1,D)
    for prefix, key, _, _ in stacks(cfg):
        for i, lp in enumerate(layer_views(params, prefix)):
            x = _layer_decode(cfg, window, x, lp, state[key], i, lengths)
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
    return _residual(cfg, lp, x, h, attn_out)[0]


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
    for prefix, key, _, _ in stacks(cfg):
        cache = state[key]
        for i, lp in enumerate(layer_views(params, prefix)):
            x = _layer_verify(cfg, window, x, lp, cache["k"][i],
                              cache["v"][i], lengths)
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
    return _residual(cfg, lp, x, h, attn_out)[0]


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
    for prefix, key, _, _ in stacks(cfg):
        cache = state[key]
        ring = not mla and prefill_rings(cache["k"].shape[2], S, window)
        for i, lp in enumerate(layer_views(params, prefix)):
            x = _layer_prefill(cfg, window, x, lp, positions, lengths,
                               cache, i, ring)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    rows = torch.arange(B, device=h.device)
    h_last = h[rows, lengths.long() - 1]          # each row's last valid
    logits = project_logits(params, h_last, cfg)
    return logits, {**state, "length": lengths}
