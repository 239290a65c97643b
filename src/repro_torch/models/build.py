"""Uniform model API: config -> Model(config, init, forward, init_state,
prefill, decode).

The port of ``repro/models/build.py`` for family ``dense``.  Params are a
flat dict of tensors keyed by the JAX checkpoint paths (see
``repro_torch.params``); they live on the device ``init`` was given.  The
decode state lives where ``init_state`` puts it: CUDA unless the caller
names another device; ``prefill`` and ``decode`` update its cache in place
and return the new state."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer


@dataclass(frozen=True)
class Model:
    config: ModelConfig

    def init(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """Random params on ``device`` from a seeded torch.Generator."""
        return transformer.init_params(seed, self.config, device)

    def forward(self, params, batch: Dict[str, Any], **kw) -> torch.Tensor:
        """batch {"tokens": (B,S)} -> logits (B,S,V)."""
        return transformer.forward(params, batch["tokens"], self.config, **kw)

    def init_state(self, batch: int, max_len: int,
                   window: Optional[int] = None, *, dtype=None, device=None):
        """A zeroed decode state for ``batch`` rows of up to ``max_len``
        tokens (a ring of the sliding window's size where one applies)."""
        return transformer.init_state(self.config, batch, max_len, dtype,
                                      window, resolve_device(device))

    def prefill(self, params, batch: Dict[str, Any], state, **kw):
        """batch {"tokens": (B,S), "lengths": (B,)} -> (logits (B,V), state)."""
        return transformer.prefill(params, batch["tokens"], state,
                                   self.config, lengths=batch.get("lengths"),
                                   **kw)

    def decode(self, params, token, state, **kw):
        """token (B,) -> (logits (B,V), state)."""
        return transformer.decode_step(params, token, state, self.config,
                                       **kw)


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_family(cfg)
    return Model(cfg)
