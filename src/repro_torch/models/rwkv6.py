"""RWKV-6 "Finch", family ``ssm``: the port of ``repro/models/rwkv6.py``.

Time-mix recurrence per head (key dim N = value dim N = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

with per-channel data-dependent decay w_t = exp(-exp(w0 + lora_w(x_w,t)))
and data-dependent token-shift interpolation (ddlerp) on every projection
input.  [arXiv:2404.05892]

The full-sequence time-mix goes through ``kernels.rwkv6_wkv.wkv6``: on a
CUDA tensor the Hopper kernel (K4), on a CPU tensor its plain chunked
version.  (The JAX model runs its own ``wkv_chunked`` with chunks of at
most 16; the Pallas kernel computes the same math.)  The one-token decode
step is plain torch, as in JAX.

The state is ``{"tm_shift", "cm_shift": (L, B, D), "wkv": (L, B, H, N, N)
float32, "length": (B,) int32}``, batch on axis 1 of every per-layer leaf.
``prefill`` and ``decode_step`` overwrite the state's tensors IN PLACE (the
JAX engine donates them) and return a new dict holding the same tensors.
``forward`` without a state (the training path, ``train_loss``) starts each
layer from zeros and keeps no state, so autograd sees no in-place write;
under ``remat`` each layer runs inside ``torch.utils.checkpoint``, the JAX
scan body's ``jax.checkpoint``, and K4's backward kernel (``Wkv6Fn`` on
CUDA) takes the gradient through the recurrence.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_wkv import wkv6
from repro_torch.models.layers import (apply_norm, compute_dtype,
                                       cross_entropy_loss, dense_init,
                                       embed_init, generator, group_norm,
                                       init_norm, stack_init)
from repro_torch.models.transformer import call_layer, layer_views, subtree
from repro_torch.params import flatten

_LORA_RANK = 32
_DECAY_RANK = 64
_MIX_NAMES = ("w", "k", "v", "r", "g")


def rwkv_dims(cfg: ModelConfig):
    """(num_heads, head_dim) derived so that H * N == d_model always."""
    N = cfg.ssm.head_dim
    assert cfg.d_model % N == 0
    return cfg.d_model // N, N


# ---------------------------------------------------------------------------
# Init (keys, shapes and dtypes of the JAX init; random values from a
# torch.Generator, the deterministic ramps as JAX's)
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    dt = compute_dtype(cfg)
    H, N = rwkv_dims(cfg)
    dev = gen.device
    f32 = torch.float32
    ramp = torch.linspace(0.0, 1.0, d, dtype=f32, device=dev)
    p = {
        "ln1": init_norm(cfg, dev),
        "ln2": init_norm(cfg, dev),
        "mu_x": ramp * 0.5,
        "mu_mix": torch.stack([ramp * 0.5 + 0.1 * i for i in range(5)]),
        "tm_a1": dense_init(gen, (d, 5 * _LORA_RANK), f32),
        "tm_a2": dense_init(gen, (5, _LORA_RANK, d), f32) * 0.1,
        "w0": torch.linspace(-6.0, -0.5, d, dtype=f32, device=dev),
        "dw_a1": dense_init(gen, (d, _DECAY_RANK), f32),
        "dw_a2": dense_init(gen, (_DECAY_RANK, d), f32) * 0.1,
        "first": dense_init(gen, (H, N), f32),
        "w_r": dense_init(gen, (d, d), dt),
        "w_k": dense_init(gen, (d, d), dt),
        "w_v": dense_init(gen, (d, d), dt),
        "w_g": dense_init(gen, (d, d), dt),
        "w_o": dense_init(gen, (d, d), dt),
        "gn_scale": torch.ones((d,), dtype=f32, device=dev),
        "gn_bias": torch.zeros((d,), dtype=f32, device=dev),
        "mu_ck": ramp * 0.5,
        "mu_cr": ramp * 0.5,
        "w_up": dense_init(gen, (d, cfg.d_ff), dt),
        "w_down": dense_init(gen, (cfg.d_ff, d), dt),
        "w_rc": dense_init(gen, (d, d), dt),
    }
    return flatten(p)


def init_params(seed: int, cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """Random params on ``device`` from a seeded ``torch.Generator``."""
    gen = generator(seed, device)
    dt = compute_dtype(cfg)
    params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt)}
    params.update(flatten({"ln_in": init_norm(cfg, gen.device),
                           "final_norm": init_norm(cfg, gen.device)}))
    params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    stacked = stack_init(gen, cfg.num_layers, init_layer, cfg)
    params.update({f"layers/{k}": v for k, v in stacked.items()})
    return params


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------


def wkv_step(r, k, v, logw, u, S):
    """Single decode step. r/k/v/logw: (B,H,N); S: (B,H,N,N)."""
    y = (torch.einsum("bhn,bhnm->bhm", r, S)
         + (r * u * k).sum(-1, keepdim=True) * v)
    S_new = torch.exp(logw)[..., None] * S + k[..., None] * v[..., None, :]
    return y, S_new


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift: name -> mixed input (B,T,D), mixed in
    float32 and cast back to x's dtype."""
    xx = x_prev - x
    base = x + xx * p["mu_x"]
    lora = torch.tanh(base.float() @ p["tm_a1"])
    lora = lora.reshape(*lora.shape[:-1], 5, _LORA_RANK)
    mix = p["mu_mix"] + torch.einsum("...ir,ird->...id", lora, p["tm_a2"])
    xf, xxf = x.float(), xx.float()
    return {name: (xf + xxf * mix[..., i, :]).to(x.dtype)
            for i, name in enumerate(_MIX_NAMES)}


def _time_mix_common(p, cfg: ModelConfig, mixed):
    """Projections shared by the full-sequence and step paths; r/k/v and
    the log decay in float32."""
    H, N = rwkv_dims(cfg)

    def heads(t):
        return t.reshape(*t.shape[:-1], H, N).float()

    r = heads(mixed["r"] @ p["w_r"])
    k = heads(mixed["k"] @ p["w_k"])
    v = heads(mixed["v"] @ p["w_v"])
    g = mixed["g"] @ p["w_g"]
    w_pre = p["w0"] + torch.tanh(mixed["w"].float() @ p["dw_a1"]) @ p["dw_a2"]
    logw = heads(-torch.exp(w_pre))                        # <= 0
    return r, k, v, g, logw


def _gate_out(p, y, g, H: int, dtype):
    y = group_norm(y, p["gn_scale"], p["gn_bias"], num_groups=H)
    return ((y * F.silu(g.float())).to(dtype)) @ p["w_o"]


def _last(x, lengths):
    """Each row's last valid position of (B,T,D): T-1, or lengths-1."""
    if lengths is None:
        return x[:, -1]
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, lengths.long() - 1]


def time_mix_full(p, cfg: ModelConfig, x, shift_state, wkv_state,
                  mask=None, lengths=None):
    """x (B,T,D). Returns (out, new_shift (B,D), new_wkv (B,H,N,N)).

    ``mask`` (B,T) zeroes pad positions' state contributions (k, v -> 0,
    decay -> 1) so a ragged prefill leaves the recurrent state exact."""
    B, T, D = x.shape
    H, _ = rwkv_dims(cfg)
    x_prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    r, k, v, g, logw = _time_mix_common(p, cfg, _ddlerp(p, x, x_prev))
    if mask is not None:
        m = mask[:, :, None, None].float()
        k, v, logw = k * m, v * m, logw * m
    y, S = wkv6(r, k, v, logw, p["first"], wkv_state)
    out = _gate_out(p, y.reshape(B, T, D), g, H, x.dtype)
    return out, _last(x, lengths), S


def time_mix_step(p, cfg: ModelConfig, x1, shift_state, wkv_state):
    """x1 (B,1,D) single token."""
    B, _, D = x1.shape
    H, _ = rwkv_dims(cfg)
    r, k, v, g, logw = _time_mix_common(p, cfg,
                                        _ddlerp(p, x1, shift_state[:, None]))
    y, S = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["first"],
                    wkv_state)
    return _gate_out(p, y.reshape(B, 1, D), g, H, x1.dtype), x1[:, 0], S


def channel_mix(p, x, x_prev):
    """rwkv6 channel-mix (relu^2). x, x_prev: (B,T,D)."""
    xx = (x_prev - x).float()
    xf = x.float()
    xk = (xf + xx * p["mu_ck"]).to(x.dtype)
    xr = (xf + xx * p["mu_cr"]).to(x.dtype)
    kk = F.relu(xk @ p["w_up"]).square()
    rr = torch.sigmoid((xr @ p["w_rc"]).float()).to(x.dtype)
    return rr * (kk @ p["w_down"])


def _layer_full(cfg, x, lp, tm_shift, cm_shift, wkv_state, mask=None,
                lengths=None):
    h = apply_norm(lp["ln1"], x, cfg)
    tm_out, new_tm_shift, new_wkv = time_mix_full(lp, cfg, h, tm_shift,
                                                  wkv_state, mask=mask,
                                                  lengths=lengths)
    x = x + tm_out
    h2 = apply_norm(lp["ln2"], x, cfg)
    h2_prev = torch.cat([cm_shift[:, None], h2[:, :-1]], dim=1)
    x = x + channel_mix(lp, h2, h2_prev)
    return x, new_tm_shift, _last(h2, lengths), new_wkv


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, batch: int, max_len: int = 0, dtype=None,
               window: Optional[int] = None, device=None) -> Dict[str, Any]:
    """Recurrent state on ``device``: O(1) in sequence length (max_len and
    window unused)."""
    del max_len, window
    L, D = cfg.num_layers, cfg.d_model
    H, N = rwkv_dims(cfg)
    dt = dtype or compute_dtype(cfg)
    return {
        "tm_shift": torch.zeros((L, batch, D), dtype=dt, device=device),
        "cm_shift": torch.zeros((L, batch, D), dtype=dt, device=device),
        "wkv": torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                           device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _hidden(params, tokens, cfg: ModelConfig, state, lengths,
            remat: bool = False):
    """Embedding, ln_in and the layer loop of the full-sequence pass.  With
    a ``state``, each layer's new recurrent state is written into its
    tensors in place; with ``state=None`` every layer starts from zeros and
    its new state is dropped (nothing is written in place, so autograd may
    run through it).  ``lengths`` (B,) masks right-padded steps; ``remat``
    runs each layer under ``torch.utils.checkpoint``.  Returns the last
    layer's hidden states (B,S,D)."""
    B, S = tokens.shape
    x = apply_norm(subtree(params, "ln_in"), params["embed"][tokens.long()],
                   cfg)
    mask = None
    if lengths is not None:
        mask = (torch.arange(S, device=x.device)[None, :]
                < lengths.to(x.device)[:, None])
    if state is None:
        zero = init_state(cfg, 1, dtype=x.dtype, device=x.device)
        start = (zero["tm_shift"][0].expand(B, -1),
                 zero["cm_shift"][0].expand(B, -1),
                 zero["wkv"][0].expand(B, -1, -1, -1))
    for i, lp in enumerate(layer_views(params, "layers")):
        if state is not None:
            start = (state["tm_shift"][i], state["cm_shift"][i],
                     state["wkv"][i])
        x, tm, cm, S_new = call_layer(_layer_full, cfg, x, lp, *start, mask,
                                      lengths, remat=remat)
        if state is not None:
            state["tm_shift"][i].copy_(tm)
            state["cm_shift"][i].copy_(cm)
            state["wkv"][i].copy_(S_new)
    return x


def forward(params, tokens, cfg: ModelConfig, *, state=None, lengths=None,
            remat: bool = False, return_state: bool = False):
    """tokens (B,S) -> logits (B,S,V); with ``return_state``, (logits, new
    state).  A given ``state`` is carried in and written in place;
    without one, every layer starts from zeros and, unless
    ``return_state``, nothing is kept (the training path).  ``lengths``
    (B,) marks right-padded rows for an exact ragged prefill; ``remat``
    recomputes each layer in backward."""
    B, S = tokens.shape
    if state is None and return_state:
        state = init_state(cfg, B, device=params["embed"].device)
    x = _hidden(params, tokens, cfg, state, lengths, remat)
    logits = apply_norm(subtree(params, "final_norm"), x, cfg) @ params["head"]
    if return_state:
        return logits, {**state, "length": state["length"] + S}
    return logits


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """batch {"tokens", "labels" (B,S), optional "mask"} -> (loss, metrics),
    as the JAX ``train_loss``: the next-token cross-entropy of ``forward``
    from zero states."""
    logits = forward(params, batch["tokens"], cfg, remat=remat)
    loss = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "loss": loss}


def prefill(params, tokens, state, cfg: ModelConfig, *, lengths=None,
            window: Optional[int] = None):
    """A right-padded prompt batch through the stack, carrying ``state``
    (written in place).  Returns (last-valid-position logits (B,V), new
    state with ``length = lengths``)."""
    B, S = tokens.shape
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    lengths = lengths.to(torch.int32)
    x = _last(_hidden(params, tokens, cfg, state, lengths), lengths)
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    return h @ params["head"], {**state, "length": lengths}


def decode_step(params, token, state, cfg: ModelConfig, *,
                window: Optional[int] = None):
    """token (B,) -> (logits (B,V), new state). O(1) per step; the state's
    tensors are written in place."""
    x = apply_norm(subtree(params, "ln_in"),
                   params["embed"][token.long()][:, None], cfg)
    for i, lp in enumerate(layer_views(params, "layers")):
        h = apply_norm(lp["ln1"], x, cfg)
        tm_out, tm, S = time_mix_step(lp, cfg, h, state["tm_shift"][i],
                                      state["wkv"][i])
        x = x + tm_out
        h2 = apply_norm(lp["ln2"], x, cfg)
        x = x + channel_mix(lp, h2, state["cm_shift"][i][:, None])
        state["tm_shift"][i].copy_(tm)
        state["cm_shift"][i].copy_(h2[:, 0])
        state["wkv"][i].copy_(S)
    logits = (apply_norm(subtree(params, "final_norm"), x, cfg)
              @ params["head"])[:, 0]
    return logits, {**state, "length": state["length"] + 1}
