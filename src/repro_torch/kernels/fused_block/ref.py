"""The plain PyTorch versions of the fused block kernels: the eager chains
that ``models/layers.py`` ran before the kernels existed, op for op.  The
wrappers run them on CPU tensors, ``models/layers.py`` wherever the
kernels do not take a call (float32, other widths, autograd; qk-norm and
MLA's rope slices), and the kernels are held to them on the card."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm_plain(x, scale, eps: float = 1e-6, residual=None):
    """RMSNorm over the last dim, statistics in float32:
    ``(x * rsqrt(mean(x^2) + eps)) * scale`` in x's dtype.  With
    ``residual``, ``x + residual`` first, and returns (x + residual, its
    norm)."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
    return y if residual is None else (x, y)


def rope_plain(x, positions, freqs):
    """Rotary embedding, half-split convention: x (..., seq, heads,
    head_dim), positions (..., seq) integer, freqs (head_dim/2,) float32."""
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_qk_plain(q, k, positions, freqs):
    """``rope_plain`` of q and of k."""
    return rope_plain(q, positions, freqs), rope_plain(k, positions, freqs)


def silu_mul_plain(gate, up):
    """SwiGLU's ``silu(gate) * up``."""
    return F.silu(gate) * up
