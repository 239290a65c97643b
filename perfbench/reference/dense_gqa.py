"""Plain float32 forward of a dense GQA transformer (llama-style: RMSNorm,
rotary embeddings in the half-split convention, causal attention with an
optional sliding window, SwiGLU MLP), read out as the class logits of the
last position: ``logits[:, -1, :C]``.

Everything runs in float32 with TF32 off, one layer at a time: a layer's
weights are cast to float32 when it runs, so the reference holds one
layer in float32 beside the served weights.  Attention is computed in
blocks of queries, with the score matrix materialised.

``precision="fp8"`` is the control: every input of a projection (weights
per output column, activations per row) rounded to float8 e4m3 with a
scale, the nearest precision below the bfloat16 the configurations serve
in.  Attention scores, softmax and norms stay float32 there.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

E4M3_MAX = 448.0
SCORE_BYTES = 1 << 30        # the score matrix of a block of queries


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim`` (the
    amax of the slice onto the format's largest value), back in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., n) @ w (n, m) in float32 (operands rounded to e4m3 under the
    fp8 control)."""
    w = w.float()
    if precision == "fp8":
        x = fp8_round(x, -1)
        w = fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (R, S, heads, hd) rotated by position (half-split pairs)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: Optional[int]) -> torch.Tensor:
    """q (R,S,H,hd), k/v (R,S,K,hd) -> (R,S,H*hd): causal softmax
    attention, each query seeing keys kpos <= qpos (and kpos > qpos -
    window), query head h reading key head h // (H / K)."""
    R, S, H, hd = q.shape
    G = H // k.shape[2]
    kk = k.repeat_interleave(G, dim=2).permute(0, 2, 3, 1)    # (R,H,hd,S)
    vv = v.repeat_interleave(G, dim=2).transpose(1, 2)        # (R,H,S,hd)
    qq = q.transpose(1, 2) / hd ** 0.5                         # (R,H,S,hd)
    out = torch.empty_like(qq)
    block = max(16, min(S, SCORE_BYTES // (4 * R * H * S)))
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        # the keys some query of the block sees: [k0, hi)
        k0 = 0 if window is None else max(0, lo - window + 1)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(k0, hi, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = qq[:, :, lo:hi] @ kk[..., k0:hi]
        s = s.masked_fill(~keep, float("-inf"))
        out[:, :, lo:hi] = torch.softmax(s, dim=-1) @ vv[:, :, k0:hi]
    return out.transpose(1, 2).reshape(R, S, H * hd)


def class_logits(weights: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                 arch: Mapping, num_classes: int,
                 precision: str = "fp32") -> torch.Tensor:
    """tokens (R, S) -> the last position's first ``num_classes`` logits,
    (R, C) float32, on the weights' device."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"precision must be 'fp32' or 'fp8', "
                         f"not {precision!r}")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _class_logits(weights, tokens, arch, num_classes,
                                 precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _class_logits(w, tokens, arch, num_classes, precision):
    R, S = tokens.shape
    H, K, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    eps, theta = arch["norm_eps"], arch["rope_theta"]
    window = arch.get("sliding_window")
    x = w["embed"][tokens.long()].float()
    for i in range(arch["num_layers"]):
        def p(name):
            return w[f"layers/{name}"][i]
        h = rms_norm(x, p("ln1/scale"), eps)
        q = rope(linear(h, p("attn/wq"), precision).view(R, S, H, hd), theta)
        k = rope(linear(h, p("attn/wk"), precision).view(R, S, K, hd), theta)
        v = linear(h, p("attn/wv"), precision).view(R, S, K, hd)
        x = x + linear(attention(q, k, v, window), p("attn/wo"), precision)
        del q, k, v, h
        h = rms_norm(x, p("ln2/scale"), eps)
        g = torch.nn.functional.silu(linear(h, p("mlp/w_gate"), precision))
        g = g * linear(h, p("mlp/w_up"), precision)
        x = x + linear(g, p("mlp/w_down"), precision)
        del g, h
    last = rms_norm(x[:, -1], w["final_norm/scale"], eps)
    return linear(last, w["head"][:, :num_classes], precision)
