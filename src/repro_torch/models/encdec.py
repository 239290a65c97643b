"""Whisper-style encoder-decoder transformer, family ``encdec``: the port
of ``repro/models/encdec.py``.

The mel-spectrogram + conv frontend is a stub, as in the JAX package:
``frames`` (B, F, d_model) arrive as precomputed frame embeddings.  The
encoder adds sinusoidal positions and runs bidirectional self-attention;
the decoder is autoregressive, with sinusoidal positions (the JAX
package's deviation from the real model's learned ones) and
cross-attention into the encoder output.  Biases, LayerNorm, GELU and the
tied embedding head come from the config.

Attention: the encoder's self-attention goes through K1 non-causal, the
decoder's through K1 causal, and its cross-attention through K1 with
Skv = F; the decode tick runs the self block and the cross block through
K2.  Float32 frames run the encoder's residual stream in float32 against
bf16 weights, as JAX promotes them (``layers.matmul``), so its K1 calls
take the float32 path.  The cross K/V are cast to q's dtype where they
enter K1, which takes one dtype, so the cross-attention of ``forward``
and ``prefill`` differs from JAX's in precision: JAX runs it in float32
and casts only the stored ``xk``/``xv``, which the decode step reads as
the port does (ROADMAP §3 records the measured logit difference).

The state is ``{"k", "v": (L, B, Smax, K, hd), "xk", "xv": (L, B, F, K,
hd), "length": (B,) int32}``, the JAX layout; ``prefill`` and
``decode_step`` write its tensors IN PLACE and return a new dict holding
the same tensors.  ``train_loss`` differentiates the forward; on the card
the encoder's, the decoder's and the cross-attention's gradients are K1's
backward kernel (the cross at Skv = F, non-causal).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, compute_dtype,
                                       cross_entropy_loss, embed_init,
                                       generator, init_mlp, init_norm, matmul,
                                       sinusoidal_positions, stack_init)
from repro_torch.models.transformer import layer_views, run_layers, subtree
from repro_torch.params import flatten


def init_enc_layer(gen: torch.Generator,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    dev = gen.device
    return flatten({"ln1": init_norm(cfg, dev), "ln2": init_norm(cfg, dev),
                    "attn": attn.init_attention(gen, cfg),
                    "mlp": init_mlp(gen, cfg)})


def init_dec_layer(gen: torch.Generator,
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    dev = gen.device
    return flatten({"ln1": init_norm(cfg, dev), "ln_x": init_norm(cfg, dev),
                    "ln2": init_norm(cfg, dev),
                    "attn": attn.init_attention(gen, cfg),
                    "xattn": attn.init_attention(gen, cfg),
                    "mlp": init_mlp(gen, cfg)})


def init_params(seed: int, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """Random params on ``device`` from a seeded ``torch.Generator``, with
    the JAX keys, shapes and dtypes."""
    gen = generator(seed, device)
    dt = compute_dtype(cfg)
    params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)}
    params.update({f"enc_layers/{k}": v for k, v in stack_init(
        gen, cfg.encdec.encoder_layers, init_enc_layer, cfg).items()})
    params.update({f"dec_layers/{k}": v for k, v in stack_init(
        gen, cfg.num_layers, init_dec_layer, cfg).items()})
    params.update(flatten({"enc_norm": init_norm(cfg, gen.device),
                           "final_norm": init_norm(cfg, gen.device)}))
    return params


def encode(params, frames, cfg: ModelConfig):
    """frames (B,F,D) stub embeddings -> encoder output (B,F,D), in the
    frames' dtype (promoted against the weights')."""
    _, F, D = frames.shape
    x = frames + sinusoidal_positions(F, D, frames.device).to(frames.dtype)
    for lp in layer_views(params, "enc_layers"):
        h = apply_norm(lp["ln1"], x, cfg)
        x = x + attn.attention_block(lp["attn"], h, cfg, causal=False,
                                     rope=False)
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
    return apply_norm(subtree(params, "enc_norm"), x, cfg)


def _dec_embed(params, tokens, cfg: ModelConfig, offset: int = 0):
    S = tokens.shape[1]
    x = params["embed"][tokens.long()]
    pos = sinusoidal_positions(S + offset, cfg.d_model, x.device)[offset:]
    return x + pos.to(x.dtype)


def _logits(params, h):
    return matmul(h, params["embed"].T)          # the tied head


def forward(params, tokens, frames, cfg: ModelConfig, *, kv_lengths=None,
            remat: bool = False):
    """Teacher-forced decoder over the full target sequence: tokens (B,S),
    frames (B,F,D) -> logits (B,S,V).  Under ``remat`` each decoder layer
    runs inside ``torch.utils.checkpoint``, as the JAX forward checkpoints
    its decoder scan body (the encoder is not)."""
    enc = encode(params, frames, cfg)
    x = _dec_embed(params, tokens, cfg)

    def body(x, lp):
        h = apply_norm(lp["ln1"], x, cfg)
        x = x + attn.attention_block(lp["attn"], h, cfg, causal=True,
                                     rope=False, kv_lengths=kv_lengths)
        hx = apply_norm(lp["ln_x"], x, cfg)
        x = x + attn.attention_block(lp["xattn"], hx, cfg, kv_x=enc,
                                     causal=False, rope=False)
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
        return x, None
    x, _ = run_layers(body, layer_views(params, "dec_layers"), x, remat=remat)
    return _logits(params, apply_norm(subtree(params, "final_norm"), x, cfg))


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """batch {"tokens", "labels", "frames", optional "mask"} -> (loss,
    metrics), as the JAX ``train_loss``."""
    logits = forward(params, batch["tokens"], batch["frames"], cfg,
                     remat=remat)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "loss": loss}


def init_state(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               window: Optional[int] = None, device=None) -> Dict[str, Any]:
    """A zeroed decode state on ``device`` (the meta device too); the
    encoder-decoder's decode has no sliding window."""
    del window
    L, F = cfg.num_layers, cfg.encdec.encoder_frames
    dt = dtype or compute_dtype(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)
    return {"k": zeros(L, batch, max_len, K, hd),
            "v": zeros(L, batch, max_len, K, hd),
            "xk": zeros(L, batch, F, K, hd), "xv": zeros(L, batch, F, K, hd),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def prefill(params, tokens, frames, state, cfg: ModelConfig, *,
            lengths=None, window: Optional[int] = None):
    """Encode the audio and teacher-force the right-padded prompt batch,
    filling the self caches and the fixed cross K/V in place.  Returns
    (last-valid-position logits (B,V), new state)."""
    del window
    B, S = tokens.shape
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    lengths = lengths.to(torch.int32)
    enc = encode(params, frames, cfg)
    x = _dec_embed(params, tokens, cfg)
    for i, lp in enumerate(layer_views(params, "dec_layers")):
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = attn.project_qkv(lp["attn"], h, cfg, rope=False)
        x = x + attn.attend(lp["attn"], q, k, v, cfg, causal=True,
                            lengths=lengths)
        # cross-attention, capturing its fixed K/V
        hx = apply_norm(lp["ln_x"], x, cfg)
        xq, xk, xv = attn.project_qkv(lp["xattn"], hx, cfg, kv_x=enc,
                                      rope=False)
        state["xk"][i].copy_(xk)
        state["xv"][i].copy_(xv)
        x = x + attn.attend(lp["xattn"], xq, state["xk"][i], state["xv"][i],
                            cfg, causal=False)
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
        attn.fill_cache(state["k"][i], k, lengths, ring=False)
        attn.fill_cache(state["v"][i], v, lengths, ring=False)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    rows = torch.arange(B, device=h.device)
    logits = _logits(params, h[rows, lengths.long() - 1])
    return logits, {**state, "length": lengths}


def decode_step(params, token, state, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B,) -> (logits (B,V), new state).  Each row's token takes the
    sinusoidal position at its length (clamped to the cache's last slot,
    as JAX clamps the gather); the self caches take the new token in
    place, the cross K/V are read."""
    del window
    lengths = state["length"]
    Smax = state["k"].shape[2]
    x = params["embed"][token.long()][:, None, :]
    pos = sinusoidal_positions(Smax, cfg.d_model, x.device)
    x = x + pos[lengths.long().clamp(max=Smax - 1)][:, None].to(x.dtype)
    for i, lp in enumerate(layer_views(params, "dec_layers")):
        h = apply_norm(lp["ln1"], x, cfg)
        out, _, _ = attn.decode_attn_block(lp["attn"], h, state["k"][i],
                                           state["v"][i], lengths, cfg,
                                           rope=False)
        x = x + out
        hx = apply_norm(lp["ln_x"], x, cfg)
        x = x + attn.cross_decode_attn_block(lp["xattn"], hx, state["xk"][i],
                                             state["xv"][i], cfg)
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg), cfg)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    return _logits(params, h)[:, 0], {**state, "length": lengths + 1}
