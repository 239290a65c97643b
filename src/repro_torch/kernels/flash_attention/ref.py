"""Plain PyTorch flash attention: the oracle the kernel is held against.

``flash_attention_ref`` ports ``repro/kernels/flash_attention/ref.py`` (the
kernel layout, materialised score matrix); ``flash_attention_plain`` takes
the model layout like ``repro/kernels/flash_attention/ops.py``.  Both
compute in float32 and return q's dtype."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        seq_len: Optional[int] = None, lengths=None):
    """q (B,H,Sq,hd); k/v (B,K,Skv,hd), Sq and Skv independent.  Naive
    masked softmax attention; query and key positions both count from 0
    (``kpos <= qpos`` under ``causal``), and ``lengths`` (B,) masks
    ``kpos >= lengths[b]``."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    seq_len = Skv if seq_len is None else seq_len
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) / (hd ** 0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = (kpos < seq_len).expand(Sq, Skv)[None]
    if lengths is not None:
        mask = mask & (kpos[None] < lengths.to(q.device)[:, None, None])
    if causal:
        mask = mask & (kpos <= qpos)[None]
    if window is not None:
        mask = mask & (kpos > qpos - window)[None]
    mask = mask[:, None]                        # (B|1, 1, Sq, Skv)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)   # rows with no valid key -> all zeros
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, lengths=None):
    """Model layout: q (B,S,H,hd), k/v (B,Skv,K,hd) -> (B,S,H,hd); Skv
    may differ from S (cross-attention)."""
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, lengths=lengths)
    return out.transpose(1, 2)
