"""Plain PyTorch flash-decode: the oracle the kernel is held against.

``decode_attention_plain`` ports ``repro/models/attention.py::
decode_attention_ref``: an e4m3 cache is dequantized to bf16 first (exact:
every e4m3fn value is a bf16 value); scores from cache-dtype operands with
float32 accumulation (a bf16 value is exact in float32, so the products are
taken in float32), a float32 softmax, and, under ``attn_dtype`` (the JAX
package's default), P cast to the dequantized cache dtype before P.V; with
``attn_dtype`` off P and V stay float32.  It materialises the (B, K, G,
Smax) score matrix.  ``paged_decode_attention_plain`` is K3's
plain version: the gathered-view oracle of the paged kernel."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import opt

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def decode_attention_plain(q, cache_k, cache_v, lengths, *,
                           window: Optional[int] = None):
    """q (B,H,hd); cache_k/v (B,Smax,K,hd); lengths (B,) = valid keys per
    row, counting the token written this tick.  Keys with
    ``kpos <= length - 1 - window`` are masked.  Returns (B,H,hd) in q's
    dtype.  A row of length 0 averages every value uniformly (NEG_INF is
    finite), as the JAX reference does."""
    B, H, hd = q.shape
    Smax, K = cache_k.shape[1], cache_k.shape[2]
    G = H // K
    if cache_k.dtype == torch.float8_e4m3fn:     # dequantize, as JAX does
        cache_k = cache_k.to(torch.bfloat16)
        cache_v = cache_v.to(torch.bfloat16)
    scale = 1.0 / (hd ** 0.5)
    qr = q.reshape(B, K, G, hd).float()
    scores = torch.einsum("bkgh,btkh->bkgt", qr, cache_k.float()) * scale
    pos = torch.arange(Smax, device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    valid = pos < lengths
    if window is not None:
        valid &= pos > (lengths - 1 - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if opt.enabled("attn_dtype"):
        probs = probs.to(cache_v.dtype).float()
    out = torch.einsum("bkgt,btkh->bkgh", probs, cache_v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths, *,
                                 window: Optional[int] = None):
    """Paged one-token attention: gather each row's pages into the
    contiguous (B, MP*ps, K, hd) cache they stand for, then run
    ``decode_attention_plain`` (``repro/kernels/decode_attention/ref.py::
    paged_decode_attention_oracle``).  q (B,H,hd); k/v_pages (P,ps,K,hd);
    page_table (B,MP) int32 (0 = the dump page); lengths (B,)."""
    B, MP = page_table.shape
    _, ps, K, hd = k_pages.shape
    idx = page_table.to(k_pages.device).long()
    ck, cv = (take(p, idx).reshape(B, MP * ps, K, hd)
              for p in (k_pages, v_pages))
    return decode_attention_plain(q, ck, cv, lengths, window=window)


def raw(t):
    """An e4m3 tensor as a uint8 view of the same storage (torch lacks some
    fp8 indexing kernels, ``index_copy_`` on the CPU among them); any other
    tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def take(t, index):
    """``t[index]``, gathered as bytes for an e4m3 tensor."""
    return raw(t)[index].view(t.dtype)
