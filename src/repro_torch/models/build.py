"""Uniform model API: config -> Model(config, init, forward).

The port of ``repro/models/build.py`` for family ``dense``.  Params are a
flat dict of tensors keyed by the JAX checkpoint paths (see
``repro_torch.params``); they live on the device ``init`` was given.  The
generate-plane entry points raise until the generate slice lands."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

GENERATE_SLICE = ("{what} is not ported yet: it comes with the dense "
                  "generate core (ROADMAP section 1, item 4)")


@dataclass(frozen=True)
class Model:
    config: ModelConfig

    def init(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """Random params on ``device`` from a seeded torch.Generator."""
        return transformer.init_params(seed, self.config, device)

    def forward(self, params, batch: Dict[str, Any], **kw) -> torch.Tensor:
        """batch {"tokens": (B,S)} -> logits (B,S,V)."""
        return transformer.forward(params, batch["tokens"], self.config, **kw)

    def init_state(self, *a, **kw):
        raise NotImplementedError(GENERATE_SLICE.format(what="init_state"))

    def prefill(self, *a, **kw):
        raise NotImplementedError(GENERATE_SLICE.format(what="prefill"))

    def decode(self, *a, **kw):
        raise NotImplementedError(GENERATE_SLICE.format(what="decode"))


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_family(cfg)
    return Model(cfg)
