"""Llama-3.2-Vision style VLM backbone, family ``vlm``: a dense GQA decoder
with gated cross-attention blocks interleaved every ``period`` layers; the
port of ``repro/models/vlm.py``.

The ViT + projector frontend is a stub, as in the JAX package:
``image_embeds`` (B, T_img, vision_dim) arrive precomputed.  Structure:
ngroups x [(period - 1) self-attention layers, 1 cross-attention block].
The self layers are ``transformer``'s; the cross block is a full block
(attention + MLP) with tanh gates on both residuals, whose K/V come from
the image and stay fixed through decode.

Attention: the self layers go through K1 over the sequence and K2 for one
token, as the dense family's do; a cross block's full attention goes
through K1 with Skv = T_img (non-causal) and its decode step through K2
with every row's length T_img.  Image K/V keep JAX's promotion (float32
embeddings against bf16 weights give float32 K/V) and are cast to q's
dtype where they enter K1, which takes one dtype.  That makes the cross
attention of ``forward`` and ``prefill`` differ from JAX's in precision:
JAX runs it in float32 (bf16 q promoted against float32 K/V) and casts
only the stored ``xk``/``xv``, which the decode step then reads as the
port does (ROADMAP §3 records the measured logit difference).

The state is ``{"k", "v": (ngroups, nself, B, Smax, K, hd), "xk", "xv":
(ngroups, B, T_img, K, hd), "length": (B,) int32}``, the JAX layout;
``prefill`` and ``decode_step`` write its tensors IN PLACE and return a
new dict holding the same tensors.  ``train_loss`` differentiates the
forward; on the card the cross-attention's gradient is K1's backward
kernel at Skv = T, non-causal.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import opt
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fused_block import rms_norm_plain
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_mlp, apply_norm, compute_dtype,
                                       cross_entropy_loss, dense_init,
                                       embed_init, generator, init_mlp,
                                       init_norm, matmul, stack_init)
from repro_torch.params import flatten


def _layout(cfg: ModelConfig):
    """(groups, self layers per group): e.g. 40 layers with 8 cross
    layers are 8 groups of 4 self layers and one cross block."""
    n_cross = len(cfg.vlm.cross_attn_layers)
    assert cfg.num_layers % n_cross == 0
    return n_cross, cfg.num_layers // n_cross - 1


def init_cross_block(gen: torch.Generator,
                     cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """One cross block's params, flat-keyed; the gates start at 0, as
    JAX's (tanh(0) silences the image path until trained)."""
    dev = gen.device
    return flatten({
        "ln1": init_norm(cfg, dev),
        "ln2": init_norm(cfg, dev),
        "attn": attn.init_attention(gen, cfg,
                                    kv_input_dim=cfg.vlm.vision_dim),
        "mlp": init_mlp(gen, cfg),
        "gate_attn": torch.zeros((), dtype=torch.float32, device=dev),
        "gate_mlp": torch.zeros((), dtype=torch.float32, device=dev),
        "q_norm_scale": torch.ones((cfg.head_dim,), dtype=torch.float32,
                                   device=dev),
        "k_norm_scale": torch.ones((cfg.head_dim,), dtype=torch.float32,
                                   device=dev),
    })


def init_params(seed: int, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """Random params on ``device`` from a seeded ``torch.Generator``, with
    the JAX keys, shapes and dtypes (``cross/gate_attn`` stacked to
    (ngroups,))."""
    ngroups, nself = _layout(cfg)
    gen = generator(seed, device)
    dt = compute_dtype(cfg)
    params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
              "head": dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)}
    params.update(flatten({"final_norm": init_norm(cfg, gen.device)}))
    params.update({f"layers/{k}": v for k, v in stack_init(
        gen, ngroups * nself, tfm.init_layer, cfg).items()})
    params.update({f"cross/{k}": v for k, v in stack_init(
        gen, ngroups, init_cross_block, cfg).items()})
    return params


def _groups(params, cfg: ModelConfig):
    """Each group's self layers and its cross block, as views of the
    stacked params."""
    _, nself = _layout(cfg)
    selfs = tfm.layer_views(params, "layers")
    crosses = tfm.layer_views(params, "cross")
    return [(selfs[g * nself:(g + 1) * nself], cp)
            for g, cp in enumerate(crosses)]


# ---------------------------------------------------------------------------
# Cross-attention block
# ---------------------------------------------------------------------------


def _cross_kv(cp, image_embeds, cfg: ModelConfig):
    """(B,T,Dv) -> k, v (B,T,K,hd); no rope on image tokens."""
    B, T, _ = image_embeds.shape
    K, hd = cfg.num_kv_heads, cfg.head_dim
    k = matmul(image_embeds, cp["attn"]["wk"]).reshape(B, T, K, hd)
    v = matmul(image_embeds, cp["attn"]["wv"]).reshape(B, T, K, hd)
    return rms_norm_plain(k, cp["k_norm_scale"]), v


def _gated(x, gate, y):
    """x + tanh(gate) * y, the product in float32 (JAX promotes the bf16
    branch against the float32 gate) and cast back to x's dtype."""
    return x + (torch.tanh(gate) * y.float()).to(x.dtype)


def _query(cp, cfg: ModelConfig, h):
    B, S, _ = h.shape
    q = matmul(h, cp["attn"]["wq"]).reshape(B, S, cfg.num_heads,
                                             cfg.head_dim)
    return rms_norm_plain(q, cp["q_norm_scale"])


def _cross_tail(cp, cfg: ModelConfig, x, attn_out):
    """The block after the attention's output projection: its gated
    residual, then the gated MLP."""
    x = _gated(x, cp["gate_attn"], attn_out)
    h2 = apply_norm(cp["ln2"], x, cfg)
    return _gated(x, cp["gate_mlp"], apply_mlp(cp["mlp"], h2, cfg))


def cross_block_full(cp, cfg: ModelConfig, x, k, v):
    """x (B,S,D) attends every image token, k/v (B,T,K,hd), through K1
    (Skv = T, non-causal)."""
    q = _query(cp, cfg, apply_norm(cp["ln1"], x, cfg))
    return _cross_tail(cp, cfg, x, attn.attend(cp["attn"], q, k, v, cfg,
                                               causal=False))


def cross_block_step(cp, cfg: ModelConfig, x1, k, v):
    """One token x1 (B,1,D) against the fixed image K/V (B,T,K,hd) through
    K2, every row's length T."""
    B = x1.shape[0]
    q = _query(cp, cfg, apply_norm(cp["ln1"], x1, cfg))
    lengths = torch.full((B,), k.shape[1], dtype=torch.int32,
                         device=x1.device)
    out = attn.decode_attention(q[:, 0], k, v, lengths)
    out = matmul(out.reshape(B, 1, cfg.num_heads * cfg.head_dim),
                 cp["attn"]["wo"])
    return _cross_tail(cp, cfg, x1, out)


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def forward(params, tokens, image_embeds, cfg: ModelConfig, *,
            window: Optional[int] = None, remat: bool = False):
    """tokens (B,S), image_embeds (B,T,Dv) -> logits (B,S,V).  Under
    ``remat`` each self layer runs inside ``torch.utils.checkpoint``, as
    the JAX forward checkpoints its self-layer scan body (the cross blocks
    are not)."""
    S = tokens.shape[1]
    window = window if window is not None else cfg.sliding_window
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, lp):
        return tfm._layer_full(cfg, window, x, lp, positions, None)
    for layers, cp in _groups(params, cfg):
        k, v = _cross_kv(cp, image_embeds, cfg)
        x, _ = tfm.run_layers(body, layers, x, remat=remat)
        x = cross_block_full(cp, cfg, x, k, v)
    h = apply_norm(tfm.subtree(params, "final_norm"), x, cfg)
    return matmul(h, params["head"])


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """batch {"tokens", "labels", "image_embeds", optional "mask"} ->
    (loss, metrics), as the JAX ``train_loss``."""
    logits = forward(params, batch["tokens"], batch["image_embeds"], cfg,
                     remat=remat)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "loss": loss}


def init_state(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               window: Optional[int] = None, device=None) -> Dict[str, Any]:
    """A zeroed decode state on ``device`` (the meta device too).  With a
    sliding window and ``ring_cache`` (the JAX package's default) the self
    caches are rings of ``min(max_len, window)`` slots.  Every cache keeps
    the compute dtype under ``kv_cache_f8``, as the JAX package's do."""
    ngroups, nself = _layout(cfg)
    dt = dtype or compute_dtype(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    window = window if window is not None else cfg.sliding_window
    if window is not None and opt.enabled("ring_cache"):
        max_len = min(max_len, window)
    T = cfg.vlm.image_tokens

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)
    return {"k": zeros(ngroups, nself, batch, max_len, K, hd),
            "v": zeros(ngroups, nself, batch, max_len, K, hd),
            "xk": zeros(ngroups, batch, T, K, hd),
            "xv": zeros(ngroups, batch, T, K, hd),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def prefill(params, tokens, image_embeds, state, cfg: ModelConfig, *,
            lengths=None, window: Optional[int] = None):
    """Process a right-padded prompt batch and its images, filling the
    self caches and the fixed image K/V in place.  Returns
    (last-valid-position logits (B,V), new state).  The self layers run
    K1 with ``lengths`` and ``window``, as the dense prefill does."""
    B, S = tokens.shape
    window = window if window is not None else cfg.sliding_window
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    lengths = lengths.to(torch.int32)
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None, :]
    ring = tfm.prefill_rings(state["k"].shape[3], S, window)
    for g, (layers, cp) in enumerate(_groups(params, cfg)):
        cache = {"k": state["k"][g], "v": state["v"][g]}
        for j, lp in enumerate(layers):
            x = tfm._layer_prefill(cfg, window, x, lp, positions, lengths,
                                   cache, j, ring)
        xk, xv = _cross_kv(cp, image_embeds, cfg)
        state["xk"][g].copy_(xk)
        state["xv"][g].copy_(xv)
        x = cross_block_full(cp, cfg, x, state["xk"][g], state["xv"][g])
    h = apply_norm(tfm.subtree(params, "final_norm"), x, cfg)
    rows = torch.arange(B, device=h.device)
    logits = matmul(h[rows, lengths.long() - 1], params["head"])
    return logits, {**state, "length": lengths}


def decode_step(params, token, state, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B,) -> (logits (B,V), new state).  The self caches take the
    new token in place; the image K/V are read."""
    window = window if window is not None else cfg.sliding_window
    lengths = state["length"]
    x = params["embed"][token.long()][:, None, :]
    for g, (layers, cp) in enumerate(_groups(params, cfg)):
        cache = {"k": state["k"][g], "v": state["v"][g]}
        for j, lp in enumerate(layers):
            x = tfm._layer_decode(cfg, window, x, lp, cache, j, lengths)
        x = cross_block_step(cp, cfg, x, state["xk"][g], state["xv"][g])
    h = apply_norm(tfm.subtree(params, "final_norm"), x, cfg)
    logits = matmul(h, params["head"])[:, 0]
    return logits, {**state, "length": lengths + 1}
