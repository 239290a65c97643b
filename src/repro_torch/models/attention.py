"""GQA attention (full / causal / sliding-window / cross): the port of the
full-sequence half of ``repro/models/attention.py``.

Shapes: x (B, S, D); q (B, S, H, hd); k/v (B, S, K, hd); GQA groups G=H/K.

Self-attention always goes through ``kernels.flash_attention``: on a CUDA
tensor that launches the Hopper kernel (any S >= 1; a shape the kernel
cannot take raises), on a CPU tensor it runs the kernel's plain version.
``gqa_attention`` stays the materialised-scores path for cross-attention
and the reference the tests hold both against.  The decode-cache ops and
MLA come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, compute_dtype, dense_init,
                                       rms_norm_simple)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   kv_input_dim: Optional[int] = None):
    """GQA projection params. ``kv_input_dim`` != None -> cross-attention
    (k/v projected from a different stream)."""
    d, hd = cfg.d_model, cfg.head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads
    dkv = kv_input_dim or d
    dt = compute_dtype(cfg)
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h * hd), dt),
        "wk": dense_init(gen, (dkv, k * hd), dt),
        "wv": dense_init(gen, (dkv, k * hd), dt),
        "wo": dense_init(gen, (h * hd, d), dt),
    }
    if cfg.use_bias:
        p.update(bq=torch.zeros((h * hd,), dtype=dt, device=dev),
                 bk=torch.zeros((k * hd,), dtype=dt, device=dev),
                 bv=torch.zeros((k * hd,), dtype=dt, device=dev),
                 bo=torch.zeros((d,), dtype=dt, device=dev))
    if cfg.use_qk_norm:
        p["qnorm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["knorm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def _linear(x, w, b=None):
    y = x @ w
    return y if b is None else y + b


def project_qkv(p, x, cfg: ModelConfig, kv_x=None, positions=None,
                rope: bool = True):
    """Project and (optionally) rotate q/k/v. Returns (B,S,H,hd), 2x(B,Skv,K,hd)."""
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _linear(x, p["wq"], p.get("bq")).reshape(B, S, h, hd)
    kk = _linear(kv_x, p["wk"], p.get("bk")).reshape(B, Skv, k, hd)
    vv = _linear(kv_x, p["wv"], p.get("bv")).reshape(B, Skv, k, hd)
    if cfg.use_qk_norm:
        q = rms_norm_simple(q, p["qnorm"])
        kk = rms_norm_simple(kk, p["knorm"])
    if rope and cfg.rope_theta > 0:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        kk = apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, vv


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------


def make_mask(S: int, Skv: int, *, causal: bool, window: Optional[int] = None,
              q_offset=0, kv_lengths=None, device=None):
    """(1|B, 1, S, Skv) boolean mask; True = attend."""
    qi = torch.arange(S, device=device)[:, None] + q_offset
    ki = torch.arange(Skv, device=device)[None, :]
    m = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    m = m[None, None]                                # (1,1,S,Skv)
    if kv_lengths is not None:                       # right-padded rows
        valid = ki[0] < kv_lengths.to(ki.device)[:, None]   # (B,Skv)
        m = m & valid[:, None, None, :]
    return m


# ---------------------------------------------------------------------------
# Core attention (materialised scores)
# ---------------------------------------------------------------------------


def gqa_attention(q, k, v, mask=None, logit_cap: Optional[float] = None):
    """q (B,S,H,hd), k/v (B,Skv,K,hd) -> (B,S,H,hd). fp32 softmax; K/V stay
    in the model dtype and products accumulate in fp32 (the JAX package's
    default ``attn_dtype`` path)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention_block(p, x, cfg: ModelConfig, *, positions=None, kv_x=None,
                    causal: bool = True, window: Optional[int] = None,
                    kv_lengths=None, rope: bool = True):
    """Full-sequence attention (prefill / ensemble forward / cross).
    Returns (B,S,D)."""
    B, S, _ = x.shape
    q, k, v = project_qkv(p, x, cfg, kv_x=kv_x, positions=positions,
                          rope=rope)
    if kv_x is None:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              lengths=kv_lengths)
    else:
        mask = None
        if causal or window is not None or kv_lengths is not None:
            mask = make_mask(S, k.shape[1], causal=causal, window=window,
                             kv_lengths=kv_lengths, device=x.device)
        out = gqa_attention(q, k, v, mask)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return _linear(out, p["wo"], p.get("bo"))
