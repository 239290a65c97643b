"""Flexible batching (paper §2.3) and the host/device boundary.

The paper's server takes any client batch size because PyTorch runs
eagerly.  The port keeps the JAX package's bucketing all the same: a batch
of n rows is padded up to the smallest configured bucket >= n, so the
shapes the device sees (and the kernels' launch grids) come from a bounded
set, and padded rows are sliced off the output.  ``compiles`` counts the
first call per bucket, so ``/metrics`` ``ensemble_compiles`` keeps its
meaning: the number of distinct shapes served.

Batches move host -> device here (``to_device``), and outputs come back
through ``to_numpy``.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class BucketSpec:
    """Monotone bucket sizes; default powers of two up to max_size."""

    sizes: Tuple[int, ...]

    @staticmethod
    def pow2(max_size: int, min_size: int = 1) -> "BucketSpec":
        sizes, s = [], min_size
        while s < max_size:
            sizes.append(s)
            s *= 2
        sizes.append(max_size)
        return BucketSpec(tuple(sizes))

    def bucket_for(self, n: int) -> int:
        if n > self.sizes[-1]:
            raise ValueError(f"batch of {n} exceeds max bucket "
                             f"{self.sizes[-1]}")
        idx = bisect.bisect_left(self.sizes, n)
        return self.sizes[idx]


def pad_to(arr: np.ndarray, n: int, axis: int = 0, fill=0):
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, n - arr.shape[axis])
    return np.pad(arr, pad, constant_values=fill)


def pad_batch(batch: Dict[str, np.ndarray], bucket: int,
              axis: int = 0) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Pad every array in ``batch`` to ``bucket`` rows; returns (padded, mask)."""
    n = next(iter(batch.values())).shape[axis]
    padded = {k: pad_to(np.asarray(v), bucket, axis) for k, v in batch.items()}
    mask = np.arange(bucket) < n
    return padded, mask


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device`` (one copy per array)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, in any float dtype, -> a float32 (or the
    integer/bool dtype it had) numpy array.  ``np.asarray`` of a CUDA or
    bfloat16 tensor fails, so logits cross to the host only here."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class FlexibleBatcher:
    """Wraps a batch-polymorphic function with bucketed dispatch.

    fn(batch_dict of device tensors) -> pytree with leading batch axis.
    Calls with ANY batch size n <= max bucket; output is sliced back to n
    rows.  ``compiles`` records the first call per bucket; ``forwards``,
    ``rows_total`` (the callers' rows) and ``padded_rows_total`` (rows
    added to reach a bucket) count every forward that returned.
    """

    def __init__(self, fn: Callable, buckets: BucketSpec,
                 device: torch.device):
        self._fn = fn
        self.buckets = buckets
        self.device = device
        self.compiles: Dict[int, int] = {}
        self.forwards = 0
        self.rows_total = 0
        self.padded_rows_total = 0

    def __call__(self, batch: Dict[str, Any]):
        n = next(iter(batch.values())).shape[0]
        bucket = self.buckets.bucket_for(n)
        padded, _mask = pad_batch(batch, bucket)
        out = self._fn(to_device(padded, self.device))
        self.compiles.setdefault(bucket, 1)
        self.forwards += 1
        self.rows_total += n
        self.padded_rows_total += bucket - n
        return tree_map(lambda t: t[:n], out)

    def counts(self) -> Dict[str, int]:
        return {"forwards": self.forwards, "rows_total": self.rows_total,
                "padded_rows_total": self.padded_rows_total}

    @property
    def num_compilations(self) -> int:
        return sum(self.compiles.values())

    def warm(self, example_batch: Dict[str, Any],
             buckets: Optional[Sequence[int]] = None) -> float:
        """Run every bucket's shape once off the hot path (first-use kernel
        builds and allocator growth).  Returns wall-clock seconds."""
        t0 = time.perf_counter()
        example = {k: np.asarray(v) for k, v in example_batch.items()}
        n = next(iter(example.values())).shape[0]
        for b in (buckets if buckets is not None else self.buckets.sizes):
            batch = {k: (v[:b] if n >= b else pad_to(v, b))
                     for k, v in example.items()}
            tree_map(to_numpy, self(batch))      # waits for the device
        return time.perf_counter() - t0


def pad_sequences(seqs: Sequence[Sequence[int]], bucket_spec: BucketSpec,
                  pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad variable-length token sequences to a length bucket.

    Returns (tokens (B, S_bucket) int32, lengths (B,) int32)."""
    maxlen = max(len(s) for s in seqs)
    S = bucket_spec.bucket_for(maxlen)
    tokens = np.full((len(seqs), S), pad_id, np.int32)
    lengths = np.zeros((len(seqs),), np.int32)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = np.asarray(s, np.int32)
        lengths[i] = len(s)
    return tokens, lengths
