"""Seeded weights made on the device by the benchmark itself: each tensor
in one call of a ``torch.Generator`` on the card, in the dtype it is
served in.  The same tensors are handed to the program and to the plain
reference."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from perfbench.harness.traffic import seed_words

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

# (shape, dtype name, kind): kind "matrix" draws N(0, 1/fan_in), "embed"
# N(0, 0.02^2), "scale" 1 + N(0, 0.1^2)
Layout = Dict[str, Tuple[Tuple[int, ...], str, str]]


def dense_gqa_layout(arch: Mapping) -> Layout:
    """The flat ``/``-joined keys of a dense GQA transformer as the port
    keeps them: ``x @ W`` orientation, layers stacked on a leading axis,
    norm scales in float32."""
    L, D, V = arch["num_layers"], arch["d_model"], arch["vocab_size"]
    H, K, hd, F = (arch["num_heads"], arch["num_kv_heads"], arch["head_dim"],
                   arch["d_ff"])
    dt = arch["dtype"]
    return {
        "embed": ((V, D), dt, "embed"),
        "final_norm/scale": ((D,), "float32", "scale"),
        "head": ((D, V), dt, "matrix"),
        "layers/attn/wq": ((L, D, H * hd), dt, "matrix"),
        "layers/attn/wk": ((L, D, K * hd), dt, "matrix"),
        "layers/attn/wv": ((L, D, K * hd), dt, "matrix"),
        "layers/attn/wo": ((L, H * hd, D), dt, "matrix"),
        "layers/ln1/scale": ((L, D), "float32", "scale"),
        "layers/ln2/scale": ((L, D), "float32", "scale"),
        "layers/mlp/w_down": ((L, F, D), dt, "matrix"),
        "layers/mlp/w_gate": ((L, D, F), dt, "matrix"),
        "layers/mlp/w_up": ((L, D, F), dt, "matrix"),
    }


def generator(seed: int, member: int, device) -> torch.Generator:
    state = np.random.SeedSequence(seed_words(seed) + [5, member])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> 1))
    return g


def make(layout: Layout, seed: int, member: int,
         device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``layout`` drawn from (``seed``, ``member``), in
    sorted key order, one call each."""
    g = generator(seed, member, device)
    out = {}
    for key in sorted(layout):
        shape, dt, kind = layout[key]
        t = torch.randn(shape, generator=g, device=device, dtype=DTYPES[dt])
        if kind == "matrix":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "embed":
            t.mul_(0.02)
        elif kind == "scale":
            t.mul_(0.1).add_(1.0)
        else:
            raise ValueError(f"unknown kind {kind!r} of {key}")
        out[key] = t
    return out
