"""K1's roofline bound: a frozen copy of the arithmetic of the port's
``flash_attention_cost`` (one forward launch: 4 hd FLOPs per visible
(query, key) pair per head; q, k and v read once and the output written
once) and the least time the card could take for it."""

from __future__ import annotations

from typing import Optional

from perfbench.costs import peaks


def visible_pairs(S: int, Skv: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs of one row that the mask keeps: key positions
    k < Skv with k <= q where causal and k > q - window where windowed."""
    total = 0
    for q in range(S):
        hi = min(q, Skv - 1) if causal else Skv - 1
        lo = max(q - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def launch_cost(B: int, S: int, Skv: int, H: int, K: int, hd: int,
                itemsize: int, *, causal: bool = True,
                window: Optional[int] = None):
    """(FLOPs, bytes) of one forward launch."""
    flops = 4 * hd * H * B * visible_pairs(S, Skv, causal, window)
    nbytes = itemsize * (2 * B * S * H * hd + 2 * B * Skv * K * hd)
    return flops, nbytes


def launch_bound_s(B: int, S: int, H: int, K: int, hd: int, itemsize: int,
                   *, window: Optional[int] = None,
                   flops_per_s: float = peaks.BF16_FLOPS) -> float:
    """Seconds the card needs at least for one causal self-attention
    launch: the larger of its operations over the peak and its bytes over
    the memory bandwidth."""
    flops, nbytes = launch_cost(B, S, S, H, K, hd, itemsize, window=window)
    return max(flops / flops_per_s, nbytes / peaks.HBM_BYTES_PER_S)
