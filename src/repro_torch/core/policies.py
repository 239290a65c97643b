"""Ensemble sensitivity policies (paper §2.1).

The paper's motivating example: n binary detectors for the same target
object; for *maximum sensitivity* the combined output is the OR of the
member outputs (y' = y_1 | y_2 | ... | y_n) — one positive member makes
the ensemble positive.  Clients choose the policy per request, so the
ensemble's sensitivity (false-negative rate) is adjusted dynamically
without redeploying models.

Two input kinds:
  binary  — member outputs (M, B) bool/int (presence of the target)
  probs   — member outputs (M, B, C) class probabilities

All policies are array-agnostic: torch tensors in -> torch ops on the
tensors' device, numpy arrays in -> pure numpy.  The serving front-end
takes the numpy path: per-request post-processing on tiny host arrays
must not pay device dispatch (see Ensemble.classify_from_logits).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def _xp(x):
    """numpy for host arrays, torch for tensors."""
    return torch if isinstance(x, torch.Tensor) else np


def _cast(x, dtype: str):
    """``x.astype(dtype)`` for numpy and torch alike."""
    if isinstance(x, torch.Tensor):
        return x.to(getattr(torch, dtype))
    return x.astype(dtype)


def _asarray(x, like):
    """``x`` as an array of ``like``'s kind (and device, for tensors)."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x, device=like.device)
    return np.asarray(x)


# --- binary policies (M, B) -> (B,) -----------------------------------------


def policy_or(outputs, weights=None):
    """Maximum sensitivity: positive if ANY member is positive."""
    return _xp(outputs).any(_cast(outputs, "bool"), axis=0)


def policy_and(outputs, weights=None):
    """Maximum specificity: positive only if ALL members agree."""
    return _xp(outputs).all(_cast(outputs, "bool"), axis=0)


def policy_majority(outputs, weights=None):
    """Positive if more than half the members are positive."""
    xp = _xp(outputs)
    M = outputs.shape[0]
    return xp.sum(_cast(outputs, "int32"), axis=0) * 2 > M


def policy_weighted(outputs, weights):
    """Weighted vote with per-member reliabilities; threshold 0.5."""
    xp = _xp(outputs)
    w = _cast(_asarray(weights, outputs), "float64")
    w = w / xp.sum(w)
    return xp.einsum("m,mb->b", w, _cast(outputs, "float64")) > 0.5


def policy_at_least_k(outputs, k: int):
    xp = _xp(outputs)
    return xp.sum(_cast(outputs, "int32"), axis=0) >= k


# --- probability policies (M, B, C) -> (B,) class ids ------------------------


def policy_soft_vote(probs, weights=None):
    """Average member distributions, then argmax."""
    xp = _xp(probs)
    if weights is not None:
        w = _asarray(weights, probs)
        w = (w / xp.sum(w))[:, None, None]
        return xp.argmax(xp.sum(probs * w, axis=0), axis=-1)
    return xp.argmax(xp.mean(probs, axis=0), axis=-1)


def policy_hard_vote(probs, weights=None):
    """Each member votes its argmax; plurality wins (ties -> lowest id)."""
    xp = _xp(probs)
    M, B, C = probs.shape
    votes = xp.argmax(probs, axis=-1)                      # (M, B)
    classes = _asarray(np.arange(C), votes)
    counts = xp.sum(votes[:, :, None] == classes[None, None, :],
                    axis=0)                                # (B, C)
    return xp.argmax(counts, axis=-1)


def policy_max_confidence(probs, weights=None):
    """The single most confident member decides."""
    xp = _xp(probs)
    conf = xp.amax(probs, axis=-1)                         # (M, B)
    best = xp.argmax(conf, axis=0)                         # (B,)
    cls = xp.argmax(probs, axis=-1)                        # (M, B)
    return cls[best, _asarray(np.arange(cls.shape[1]), cls)]


BINARY_POLICIES: Dict[str, Callable] = {
    "or": policy_or,
    "and": policy_and,
    "majority": policy_majority,
    "weighted": policy_weighted,
}

PROB_POLICIES: Dict[str, Callable] = {
    "soft_vote": policy_soft_vote,
    "hard_vote": policy_hard_vote,
    "max_confidence": policy_max_confidence,
}


def get_policy(name: str) -> Callable:
    if name in BINARY_POLICIES:
        return BINARY_POLICIES[name]
    if name in PROB_POLICIES:
        return PROB_POLICIES[name]
    raise KeyError(f"unknown policy {name!r}; available: "
                   f"{sorted(BINARY_POLICIES) + sorted(PROB_POLICIES)}")
