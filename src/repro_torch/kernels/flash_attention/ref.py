"""Plain PyTorch flash attention: the oracle the kernels are held against.

``flash_attention_ref`` ports ``repro/kernels/flash_attention/ref.py`` (the
kernel layout, materialised score matrix); ``flash_attention_plain`` takes
the model layout like ``repro/kernels/flash_attention/ops.py``.  Both
compute in float32 and return q's dtype.  ``flash_attention_bwd_plain`` is
the backward kernel's formula written out with P materialised; only the
tests and ``chip_smoke.py`` call it (on the CPU, autograd differentiates
``flash_attention_plain``)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(Sq: int, Skv: int, device, *, causal: bool, window, seq_len,
          lengths):
    """(B|1, 1, Sq, Skv) bool: the (query, key) pairs K1 keeps."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = (kpos < seq_len).expand(Sq, Skv)[None]
    if lengths is not None:
        mask = mask & (kpos[None] < lengths.to(device)[:, None, None])
    if causal:
        mask = mask & (kpos <= qpos)[None]
    if window is not None:
        mask = mask & (kpos > qpos - window)[None]
    return mask[:, None]


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        seq_len: Optional[int] = None, lengths=None,
                        return_lse: bool = False):
    """q (B,H,Sq,hd); k/v (B,K,Skv,hd), Sq and Skv independent.  Naive
    masked softmax attention; query and key positions both count from 0
    (``kpos <= qpos`` under ``causal``), and ``lengths`` (B,) masks
    ``kpos >= lengths[b]``.  With ``return_lse`` also each row's
    log-sum-exp of the scaled scores (B,H,Sq) float32, -inf where a row
    sees no key."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    seq_len = Skv if seq_len is None else seq_len
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) / (hd ** 0.5)
    mask = _mask(Sq, Skv, q.device, causal=causal, window=window,
                 seq_len=seq_len, lengths=lengths)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    p = torch.where(mask, p, 0.0)   # rows with no valid key -> all zeros
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, lengths=None,
                          return_lse: bool = False):
    """Model layout: q (B,S,H,hd), k/v (B,Skv,K,hd) -> (B,S,H,hd); Skv
    may differ from S (cross-attention).  With ``return_lse`` also the
    (B,H,S) float32 log-sum-exp the kernel writes."""
    res = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, lengths=lengths,
                              return_lse=return_lse)
    if not return_lse:
        return res.transpose(1, 2)
    return res[0].transpose(1, 2), res[1]


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: Optional[int] = None, lengths=None):
    """The backward kernel's formula in full, model layout: with
    P = exp(scale Q K^T - lse) on the visible pairs (else 0),
    Delta = rowsum(dO * O) and dS = P * (dO V^T - Delta), returns
    (dq, dk, dv) = (scale dS K, scale dS^T Q, P^T dO), the G query heads of
    a KV head summed into its dk/dv, each in its input's dtype.  P and the
    products are float32."""
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / (hd ** 0.5)
    qf, kf, vf, of, dof = (t.float().transpose(1, 2)
                           for t in (q, k, v, o, do))    # (B,heads,seq,hd)
    kk = kf.repeat_interleave(G, dim=1)
    vv = vf.repeat_interleave(G, dim=1)
    mask = _mask(S, Skv, q.device, causal=causal, window=window,
                 seq_len=Skv, lengths=lengths)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    delta = (dof * of).sum(-1)                            # (B,H,S)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(B, K, G, Skv, hd).sum(2)
    dv = dv.reshape(B, K, G, Skv, hd).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))
