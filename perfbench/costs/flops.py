"""Useful model FLOPs of a dense GQA transformer's forward.

Per token: 2 x the parameters of its layers (embedding and head left out,
norm scales too), plus 4 x (heads x head_dim) x the keys the token's query
sees, per layer (causal, and windowed where the configuration has a
window).  Padded rows and logits the readout never reads are not useful
work, so they count for nothing here."""

from __future__ import annotations

from typing import Mapping, Optional


def layer_params(arch: Mapping) -> int:
    """Weights of one layer: q, k, v and o projections and the SwiGLU MLP."""
    d, hd = arch["d_model"], arch["head_dim"]
    h, k, ff = arch["num_heads"], arch["num_kv_heads"], arch["d_ff"]
    attn = d * h * hd + 2 * d * k * hd + h * hd * d
    return attn + 3 * d * ff


def keys_seen(S: int, window: Optional[int]) -> int:
    """Keys summed over the S queries of a causal (windowed) row."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    # queries 0..window-1 see q + 1 keys, the rest see window each
    return window * (window + 1) // 2 + (S - window) * window


def row_flops(arch: Mapping, S: int) -> int:
    """Useful FLOPs of one member's forward over one row of S tokens."""
    L = arch["num_layers"]
    dense = 2 * layer_params(arch) * S * L
    attn = 4 * arch["num_heads"] * arch["head_dim"] * keys_seen(
        S, arch.get("sliding_window")) * L
    return dense + attn


def token_flops(arch: Mapping, S: int) -> float:
    """``row_flops`` per token of the row."""
    return row_flops(arch, S) / S
