"""Uniform model API: config -> Model(config, init, loss, forward,
init_state, prefill, decode, input_specs, state_specs).

The port of ``repro/models/build.py`` for the families ``dense`` and
``moe`` (``transformer.py``; GQA or MLA attention), ``ssm`` (``rwkv6.py``),
``hybrid`` (``hybrid.py``), ``vlm`` (``vlm.py``, with ``image_embeds``)
and ``encdec`` (``encdec.py``, with ``frames``); ``build_model`` raises
for any other family.  Params are a flat dict of
tensors keyed by the JAX checkpoint paths (see ``repro_torch.params``);
they live on the device ``init`` was given.  The decode state lives
where ``init_state`` puts it: CUDA unless the caller names another
device; ``prefill`` and ``decode`` update its tensors in place and return
the new state.  ``input_specs`` and ``state_specs`` give a step's inputs
and decode state as meta tensors (shapes and dtypes, no storage), what the
dry-run (``launch/dryrun.py``) runs a step on."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels.common import resolve_device
from repro_torch.models import encdec, hybrid, rwkv6, transformer, vlm
from repro_torch.models.layers import compute_dtype

_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": rwkv6,
             "hybrid": hybrid, "vlm": vlm, "encdec": encdec}
# the frontend stub's input a family takes beside the tokens, as the JAX
# Model passes it
_EXTRAS = {"vlm": "image_embeds", "encdec": "frames"}


@dataclass(frozen=True)
class Model:
    config: ModelConfig

    @property
    def module(self):
        """The module that implements this config's family."""
        return _FAMILIES[self.config.family]

    def init(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """Random params on ``device`` from a seeded torch.Generator."""
        return self.module.init_params(seed, self.config, device)

    def _inputs(self, batch: Dict[str, Any]):
        """The tokens, and the image embeddings or frames where the
        family takes them."""
        extra = _EXTRAS.get(self.config.family)
        return ((batch["tokens"],) if extra is None
                else (batch["tokens"], batch[extra]))

    def forward(self, params, batch: Dict[str, Any], **kw) -> torch.Tensor:
        """batch {"tokens": (B,S)} (with "image_embeds" (B,T,Dv) for vlm,
        "frames" (B,F,D) for encdec) -> logits (B,S,V)."""
        return self.module.forward(params, *self._inputs(batch), self.config,
                                   **kw)

    def loss(self, params, batch: Dict[str, Any], **kw):
        """batch {"tokens", "labels" (B,S)} (with the family's extras, and
        an optional "mask") -> (loss, metrics), as the JAX ``Model.loss``,
        for every family; ``remat`` (default True) recomputes each layer
        (each Mamba-2 layer of the hybrid family) in backward.  On CUDA the
        gradients run through the kernels' backward kernels (K1, K4,
        K5)."""
        return self.module.train_loss(params, batch, self.config, **kw)

    def like(self) -> Dict[str, torch.Tensor]:
        """``init``'s keys, shapes and dtypes as meta tensors (no storage,
        no random draws): what a checkpoint restores into."""
        return self.init(0, "meta")

    def input_specs(self, shape: InputShape) -> Dict[str, torch.Tensor]:
        """Every model input of one step of ``shape`` as meta tensors, with
        the JAX package's dtypes (``repro/models/build.py``,
        ``_token_specs``): train {"tokens", "labels"} (B,S) int32, prefill
        {"tokens" (B,S), "lengths" (B,)} int32, decode {"token" (B,)}
        int32; vlm adds "image_embeds" (B,T,Dv) and encdec "frames"
        (B,F,D) in the compute dtype, except to a decode step."""
        cfg = self.config
        B, S = shape.global_batch, shape.seq_len

        def meta(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")
        if shape.kind == "train":
            out = {"tokens": meta(B, S), "labels": meta(B, S)}
        elif shape.kind == "prefill":
            out = {"tokens": meta(B, S), "lengths": meta(B)}
        else:   # decode: ONE new token; the state is supplied separately
            out = {"token": meta(B)}
        dt = compute_dtype(cfg)
        if cfg.family == "vlm" and shape.kind != "decode":
            out["image_embeds"] = meta(B, cfg.vlm.image_tokens,
                                       cfg.vlm.vision_dim, dtype=dt)
        if cfg.family == "encdec" and shape.kind != "decode":
            out["frames"] = meta(B, cfg.encdec.encoder_frames, cfg.d_model,
                                 dtype=dt)
        return out

    def state_specs(self, batch: int, max_len: int,
                    window: Optional[int] = None):
        """``init_state``'s tree as meta tensors."""
        return self.init_state(batch, max_len, window, device="meta")

    def init_state(self, batch: int, max_len: int,
                   window: Optional[int] = None, *, dtype=None, device=None):
        """A zeroed decode state for ``batch`` rows of up to ``max_len``
        tokens (KV caches are rings of the window's size where one
        applies; recurrent states do not grow with ``max_len``)."""
        return self.module.init_state(self.config, batch, max_len, dtype,
                                      window, resolve_device(device))

    def prefill(self, params, batch: Dict[str, Any], state, **kw):
        """batch {"tokens": (B,S), "lengths": (B,)} (and the family's
        extras, as ``forward``) -> (logits (B,V), state)."""
        return self.module.prefill(params, *self._inputs(batch), state,
                                   self.config, lengths=batch.get("lengths"),
                                   **kw)

    def decode(self, params, token, state, **kw):
        """token (B,) -> (logits (B,V), state)."""
        return self.module.decode_step(params, token, state, self.config,
                                       **kw)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    return Model(cfg)
