"""The numbers the check compares with the plain reference."""

from __future__ import annotations

from typing import Sequence

import numpy as np

# what ``logit_err`` reads where a row is missing or a logit is not finite:
# finite, so that the result line stays strict JSON
MISSING = 1e30


def logit_err(program: Sequence[np.ndarray],
              reference: Sequence[np.ndarray]) -> float:
    """The widest gap between a class logit the program produced and the
    reference's, over every sampled row, class and member, as a share of
    the reference logits' root mean square (``MISSING`` where a row is
    missing or a logit is not finite)."""
    gaps, scale = [], []
    for p, r in zip(program, reference):
        p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
        if p.shape != r.shape or not p.size:
            return MISSING
        gaps.append(np.abs(p - r).max())
        scale.append(np.sqrt(np.mean(r ** 2)))
    err = float(np.max(gaps) / max(float(np.mean(scale)), 1e-30))
    return err if np.isfinite(err) else MISSING
