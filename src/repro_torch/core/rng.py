"""The parts of ``jax.random`` that sampling uses, as torch integer ops.

Seeded generation draws token j of a request with
``categorical(fold_in(PRNGKey(seed), j), logits)``; reproducing the JAX
package's streams token for token needs JAX's own generator, not a
``torch.Generator``.  This module reimplements it for the configuration
the JAX package runs with (jax 0.9.0, 32-bit mode,
``jax_threefry_partitionable=True``, low-dynamic-range gumbel):

* ``threefry2x32``: the Threefry-2x32 hash (20 rounds, key schedule with
  the 0x1BD11BDA parity word), ``jax._src.prng._threefry2x32_lowering``;
* ``base_key`` / ``PRNGKey``: a raw key ``[0, seed mod 2**32]``;
* ``fold_in``: ``threefry2x32(key, (0, data))``;
* ``bits``: the partitionable ``random_bits`` for a ``(..., n)`` draw:
  counter i hashes the pair ``(0, i)`` and the two output words are xored;
* ``uniform`` (``minval=tiny``), ``gumbel`` (``-log(-log(u))``) and
  ``categorical`` (gumbel-max, first maximum).

Every word is held in an int64 tensor masked to 32 bits, so one code path
runs on the CPU and on the card; keys are int64 tensors of shape
``(..., 2)``.  Integer results are bit-identical to ``jax.random``;
floating-point ones agree to the last ulps of ``log``."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the counter words (x0, x1) under the key
    words (k0, k1); every argument an int64 tensor of 32-bit words (they
    broadcast).  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def base_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as host uint32[2]: in 32-bit mode the
    high word is 0 and the low word is the seed modulo 2**32."""
    return np.array([0, int(seed) & MASK], np.uint32)


PRNGKey = base_key


def as_key(key: Union[np.ndarray, torch.Tensor], device=None) -> torch.Tensor:
    """A raw key (or a stack of them) as an int64 tensor of 32-bit words."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device or key.device, dtype=torch.int64) & MASK
    arr = np.asarray(key).astype(np.int64) & MASK
    return torch.from_numpy(arr).to(device or "cpu")


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` for keys (..., 2) and data (...) (or a
    scalar): the key hashes the counter pair (0, data mod 2**32)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o0, o1], dim=-1)


def bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of a (..., 2)
    stack: (..., n) int64 holding 32-bit words."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(i), i)
    return o0 ^ o1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)``: the top 23
    bits of each word become the mantissa of a float in [1, 2), minus 1,
    scaled to [minval, 1) and floored at minval."""
    w = (bits(key, n) >> 9) | 0x3F800000
    f = w.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(1.0) - lo)          # both in float32, as JAX
    return torch.clamp_min(f * span + float(lo), float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in its default "low"
    mode: ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n, minval=_F32_TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis for each
    key of a (..., 2) stack against logits (..., V): the first argmax of
    gumbel noise plus the logits.  Returns int64 ids."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits.float(), dim=-1)
