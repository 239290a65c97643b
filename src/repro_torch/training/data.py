"""Deterministic synthetic LM data pipeline: a copy of
``repro/training/data.py`` (numpy only), so the port draws the same
batches byte for byte.

Sequences follow a learnable second-order pattern with noise:
    t_{i+1} = (a * t_i + b * t_{i-1} + c) mod V          (prob 1-noise)
             ~ Uniform(V)                                 (prob noise)
with (a, b, c) drawn per-sequence from a small set of "dialects", so a
model must infer the dialect in-context — losses drop quickly but not to
zero, giving training curves with signal at smoke scale.

The pipeline is an infinite, seekable iterator (step -> batch) so
checkpoint-resume reproduces the exact stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    noise: float = 0.05
    num_dialects: int = 8
    seed: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        self.dialects = rng.integers(
            1, V, size=(cfg.num_dialects, 3))         # (a, b, c)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        d = rng.integers(0, cfg.num_dialects, size=B)
        a, b, c = (self.dialects[d, i][:, None] for i in range(3))
        seq = np.empty((B, S + 1), np.int64)
        seq[:, 0] = rng.integers(0, V, size=B)
        seq[:, 1] = rng.integers(0, V, size=B)
        for i in range(1, S):
            nxt = (a[:, 0] * seq[:, i] + b[:, 0] * seq[:, i - 1]
                   + c[:, 0]) % V
            noise = rng.random(B) < cfg.noise
            seq[:, i + 1] = np.where(noise, rng.integers(0, V, size=B), nxt)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
