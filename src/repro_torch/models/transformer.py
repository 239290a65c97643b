"""Decoder-only transformer, family ``dense``: the port of the full-sequence
half of ``repro/models/transformer.py``.

Covers yi-9b, mistral-large-123b, command-r-plus-104b (LayerNorm, parallel
block, tied embeddings) and h2o-danube-1.8b (native sliding window).  The
layers run as a Python loop over views of the stacked ``(L, ...)`` params.
MoE, MLA and the decode path come with later slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, compute_dtype,
                                       dense_init, embed_init, init_mlp,
                                       init_norm)
from repro_torch.params import flatten, unflatten

LATER_SLICE = ("family {fam!r} ({name}) is not ported yet: moe/MLA, ssm, "
               "hybrid, vlm and encdec come with ROADMAP section 1, item 10 "
               "(other families)")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            LATER_SLICE.format(fam=cfg.family, name=cfg.name))


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
    """Random params on ``device`` from a seeded ``torch.Generator``.

    Stacked layer tensors are allocated once and filled a layer at a time,
    so the float32 temporaries never exceed one layer's matrix."""
    check_family(cfg)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    dt = compute_dtype(cfg)
    params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)}
    params.update(flatten({"final_norm": init_norm(cfg, gen.device)}))
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    stacked: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        for k, v in init_layer(gen, cfg).items():
            if i == 0:
                stacked[k] = torch.empty((cfg.num_layers, *v.shape),
                                         dtype=v.dtype, device=v.device)
            stacked[k][i] = v
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


def _layer_full(cfg: ModelConfig, window, x, lp, positions, kv_lengths):
    h = apply_norm(lp["ln1"], x, cfg)
    attn_out = attn.attention_block(lp["attn"], h, cfg, positions=positions,
                                    causal=True, window=window,
                                    kv_lengths=kv_lengths)
    if cfg.parallel_block:
        return x + attn_out + apply_mlp(lp["mlp"], h, cfg)
    x = x + attn_out
    h2 = apply_norm(lp["ln2"], x, cfg)
    return x + apply_mlp(lp["mlp"], h2, cfg)


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
