"""Zamba2-style hybrid, family ``hybrid``: a Mamba-2 backbone plus ONE
shared attention block; the port of ``repro/models/hybrid.py``.

The shared transformer block's weights are applied every
``hybrid.shared_block_period`` layers (9 applications for 54 layers).  Each
application j gets its own low-rank (LoRA) adapter on the fused qkv
projection, and the block consumes concat(hidden, original embeddings)
projected back to d_model, both per arXiv:2411.15242.

Its self-attention goes through ``kernels.flash_attention`` (K1) over the
full sequence and ``kernels.decode_attention`` (K2) for one token, as every
self-attention of the port does (the JAX model takes the materialised
scores and ``decode_attention_ref``); the backbone's scan goes through K5
(``models/mamba2.py``).

The state is ``{"conv": (L, B, K-1, C), "ssd": (L, B, H, P, N) float32,
"shared_k", "shared_v": (napp, B, Smax, Kv, hd), "length": (B,) int32}``,
batch on axis 1 of every per-layer leaf.  The shared caches keep
``min(max_len, window)`` slots, a ring, under ``ring_cache`` (the JAX
package's default) and ``max_len`` slots without it; they keep the
compute dtype under ``kv_cache_f8``, as the JAX package's do.
``prefill`` and ``decode_step`` write the state's tensors IN PLACE and
return a new dict holding the same tensors.  ``forward`` without a state
(the training path, ``train_loss``) starts each Mamba-2 layer from zeros
and keeps no state, so autograd sees no in-place write; under ``remat``
each Mamba-2 layer runs inside ``torch.utils.checkpoint`` and the shared
block does not, as JAX remats ``mamba_step`` alone, so K1's forward runs
once a step there.  The gradients run through K5's backward kernel
(``SsdFn``) and K1's (``FlashAttentionFn``) on CUDA.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import opt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, apply_rope_qk,
                                       compute_dtype, cross_entropy_loss,
                                       dense_init, embed_init, generator,
                                       init_mlp, init_norm, stack_init)
from repro_torch.models.mamba2 import (init_mamba2_layer, init_mamba2_state,
                                       mamba2_full, mamba2_step)
from repro_torch.models.transformer import call_layer, layer_views, subtree
from repro_torch.params import flatten

_LORA_RANK = 64


def _num_groups(cfg: ModelConfig) -> int:
    period = cfg.hybrid.shared_block_period
    assert cfg.num_layers % period == 0, "layers must divide by period"
    return cfg.num_layers // period


def init_params(seed: int, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """Random params on ``device`` from a seeded ``torch.Generator`` (the
    JAX keys, shapes and dtypes; ``lora_b`` zeros, as JAX's)."""
    gen = generator(seed, device)
    d, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    dt = compute_dtype(cfg)
    napp = _num_groups(cfg)
    dev = gen.device
    shared = flatten({
        "ln_h": init_norm(cfg, dev),
        "ln_e": init_norm(cfg, dev),
        "concat_proj": dense_init(gen, (2 * d, d), dt),
        "attn": attn.init_attention(gen, cfg),
        "ln1": init_norm(cfg, dev),
        "ln2": init_norm(cfg, dev),
        "mlp": init_mlp(gen, cfg),
    })
    shared.update(stack_init(gen, napp, lambda g: {
        "lora_a": dense_init(g, (d, _LORA_RANK), dt),
        "lora_b": torch.zeros((_LORA_RANK, (H + 2 * K) * hd), dtype=dt,
                              device=dev)}))
    params = {"embed": embed_init(gen, (cfg.vocab_size, d), dt)}
    params.update(flatten({"final_norm": init_norm(cfg, dev)}))
    params["head"] = dense_init(gen, (d, cfg.vocab_size), dt)
    params.update({f"mamba/{k}": v for k, v in stack_init(
        gen, cfg.num_layers, init_mamba2_layer, cfg).items()})
    params.update({f"mamba_ln/{k}": v for k, v in stack_init(
        gen, cfg.num_layers, lambda g: init_norm(cfg, dev)).items()})
    params.update({f"shared/{k}": v for k, v in shared.items()})
    return params


# ---------------------------------------------------------------------------
# Shared attention block
# ---------------------------------------------------------------------------


def _shared_qkv(sp, xin, lora_a, lora_b, cfg: ModelConfig):
    """Fused qkv with the per-application LoRA delta."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ap = sp["attn"]
    delta = (xin @ lora_a) @ lora_b                    # (B,S,(H+2K)*hd)
    dq, dk, dv = torch.split(delta, [H * hd, K * hd, K * hd], dim=-1)
    B, S = xin.shape[:2]
    q = (xin @ ap["wq"] + dq).reshape(B, S, H, hd)
    k = (xin @ ap["wk"] + dk).reshape(B, S, K, hd)
    v = (xin @ ap["wv"] + dv).reshape(B, S, K, hd)
    return q, k, v


def _block_in(sp, cfg: ModelConfig, x, e0):
    xin = torch.cat([apply_norm(sp["ln_h"], x, cfg),
                     apply_norm(sp["ln_e"], e0, cfg)], dim=-1)
    return xin @ sp["concat_proj"]


def _block_out(sp, cfg: ModelConfig, x, xin, out):
    B, S = out.shape[:2]
    xin = xin + out.reshape(B, S, cfg.num_heads * cfg.head_dim) \
        @ sp["attn"]["wo"]
    xin = xin + apply_mlp(sp["mlp"], apply_norm(sp["ln2"], xin, cfg), cfg)
    return x + xin


def shared_block_full(sp, cfg: ModelConfig, x, e0, lora_a, lora_b, positions,
                      window, kv_lengths=None):
    """Full-sequence shared block. Returns (x, (k, v)) for cache capture.
    Attention through K1 (causal, windowed, ragged ``kv_lengths``)."""
    xin = _block_in(sp, cfg, x, e0)
    h = apply_norm(sp["ln1"], xin, cfg)
    q, k, v = _shared_qkv(sp, h, lora_a, lora_b, cfg)
    q, k = apply_rope_qk(q, k, positions, cfg.rope_theta)
    out = attn.flash_attention(q, k, v, causal=True, window=window,
                               lengths=kv_lengths)
    return _block_out(sp, cfg, x, xin, out), (k, v)


def shared_block_step(sp, cfg: ModelConfig, x1, e0_1, lora_a, lora_b,
                      cache_k, cache_v, lengths, window):
    """Single-token shared block; writes this application's cache in place
    (a ring when ``Smax <= window``).  Attention through K2."""
    xin = _block_in(sp, cfg, x1, e0_1)
    h = apply_norm(sp["ln1"], xin, cfg)
    q, k, v = _shared_qkv(sp, h, lora_a, lora_b, cfg)
    positions = lengths[:, None]
    q, k = apply_rope_qk(q, k, positions, cfg.rope_theta)
    Smax = cache_k.shape[1]
    if window is not None and Smax <= window:           # ring cache
        ck, cv = attn.ring_write(cache_k, cache_v, k, v, lengths, Smax)
        out = attn.decode_attention(q[:, 0], ck, cv,
                                    attn.ring_lengths(lengths, Smax))
    else:
        ck, cv = attn.cache_write(cache_k, cache_v, k, v, lengths)
        out = attn.decode_attention(q[:, 0], ck, cv, lengths + 1,
                                    window=window)
    return _block_out(sp, cfg, x1, xin, out[:, None]), ck, cv


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               window: Optional[int] = None, device=None) -> Dict[str, Any]:
    """A zeroed state on ``device``; under ``ring_cache`` the shared caches
    keep ``min(max_len, window)`` slots (the shared block is windowed by
    design)."""
    napp = _num_groups(cfg)
    st = init_mamba2_state(cfg, cfg.num_layers, batch, device)
    dt = dtype or compute_dtype(cfg)
    window = window if window is not None else cfg.hybrid.shared_window
    if opt.enabled("ring_cache"):
        max_len = min(max_len, window)
    shape = (napp, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    st["shared_k"] = torch.zeros(shape, dtype=dt, device=device)
    st["shared_v"] = torch.zeros(shape, dtype=dt, device=device)
    st["length"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return st


def _mamba_layer(cfg: ModelConfig, x, ln, lp, conv_state, ssd_state,
                 lengths):
    """One backbone layer: x + Mamba-2(norm(x)); returns (x, new conv
    state, new SSD state)."""
    out, nc, ns = mamba2_full(lp, cfg, apply_norm(ln, x, cfg), conv_state,
                              ssd_state, lengths=lengths)
    return x + out, nc, ns


def _run(params, tokens, cfg: ModelConfig, state, lengths, window,
         capture, remat: bool = False):
    """The full-sequence stack: per application j, the shared block, then
    its ``period`` Mamba-2 layers.  With a ``state``, writes the backbone's
    states into it in place; with ``state=None`` each layer starts from
    zeros and its new state is dropped (nothing is written in place, so
    autograd may run through it).  ``capture(j, k, v)`` takes each
    application's K/V; ``remat`` runs each Mamba-2 layer (not the shared
    block) under ``torch.utils.checkpoint``.  Returns the final hidden
    states."""
    B, S = tokens.shape
    napp = _num_groups(cfg)
    period = cfg.num_layers // napp
    e0 = params["embed"][tokens.long()]
    x = e0
    positions = torch.arange(S, device=x.device)[None, :]
    sp = subtree(params, "shared")
    lns = layer_views(params, "mamba_ln")
    mambas = layer_views(params, "mamba")
    if state is None:
        zero = init_mamba2_state(cfg, 1, 1, x.device)
        start = (zero["conv"][0].expand(B, -1, -1),
                 zero["ssd"][0].expand(B, -1, -1, -1))
    for j in range(napp):
        x, (k, v) = shared_block_full(
            sp, cfg, x, e0, sp["lora_a"][j], sp["lora_b"][j], positions,
            window, kv_lengths=lengths)
        capture(j, k, v)
        for i in range(j * period, (j + 1) * period):
            if state is not None:
                start = (state["conv"][i], state["ssd"][i])
            x, nc, ns = call_layer(_mamba_layer, cfg, x, lns[i], mambas[i],
                                   *start, lengths, remat=remat)
            if state is not None:
                state["conv"][i].copy_(nc)
                state["ssd"][i].copy_(ns)
    return apply_norm(subtree(params, "final_norm"), x, cfg)


def forward(params, tokens, cfg: ModelConfig, *, state=None, lengths=None,
            window: Optional[int] = None, remat: bool = False):
    """tokens (B,S) -> logits (B,S,V).  A given ``state`` carries the
    backbone's conv and SSD states in and is written in place; without
    one every layer starts from zeros and nothing is kept (the training
    path).  ``remat`` recomputes each Mamba-2 layer in backward."""
    window = window if window is not None else cfg.hybrid.shared_window
    h = _run(params, tokens, cfg, state, lengths, window,
             lambda j, k, v: None, remat)
    return h @ params["head"]


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """batch {"tokens", "labels" (B,S), optional "mask"} -> (loss, metrics),
    as the JAX ``train_loss``: the next-token cross-entropy of ``forward``
    from zero states."""
    logits = forward(params, batch["tokens"], cfg, remat=remat)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "loss": loss}


def prefill(params, tokens, state, cfg: ModelConfig, *, lengths=None,
            window: Optional[int] = None):
    """A right-padded prompt batch through the stack: the backbone's states
    and each application's shared cache are written in place (a ring of
    the last Smax positions where the cache is ring-sized).  Returns
    (last-valid-position logits (B,V), new state)."""
    B, S = tokens.shape
    window = window if window is not None else cfg.hybrid.shared_window
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    lengths = lengths.to(torch.int32)
    ck_all, cv_all = state["shared_k"], state["shared_v"]
    Smax = ck_all.shape[2]
    ring = Smax < S or Smax <= window

    def capture(j, k, v):
        for cache, new in ((ck_all[j], k), (cv_all[j], v)):
            attn.fill_cache(cache, new, lengths, ring)

    h = _run(params, tokens, cfg, state, lengths, window, capture)
    rows = torch.arange(B, device=h.device)
    logits = h[rows, lengths.long() - 1] @ params["head"]
    return logits, {**state, "length": lengths}


def decode_step(params, token, state, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B,) -> (logits (B,V), new state); the state's tensors are
    written in place."""
    napp = _num_groups(cfg)
    period = cfg.num_layers // napp
    window = window if window is not None else cfg.hybrid.shared_window
    lengths = state["length"]
    e0 = params["embed"][token.long()][:, None]
    x = e0
    sp = subtree(params, "shared")
    lns = layer_views(params, "mamba_ln")
    mambas = layer_views(params, "mamba")
    for j in range(napp):
        x, _, _ = shared_block_step(sp, cfg, x, e0, sp["lora_a"][j],
                                    sp["lora_b"][j], state["shared_k"][j],
                                    state["shared_v"][j], lengths, window)
        for i in range(j * period, (j + 1) * period):
            h = apply_norm(lns[i], x, cfg)
            out, nc, ns = mamba2_step(mambas[i], cfg, h,
                                      state["conv"][i], state["ssd"][i])
            x = x + out
            state["conv"][i].copy_(nc)
            state["ssd"][i].copy_(ns)
    logits = (apply_norm(subtree(params, "final_norm"), x, cfg)
              @ params["head"])[:, 0]
    return logits, {**state, "length": lengths + 1}
