"""Mamba-2 (SSD) blocks, the zamba2 backbone: the port of
``repro/models/mamba2.py``.

State-space dual recurrence per head (P = head_dim, N = state_size):

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T       h: (P, N)
    y_t = h_t C_t + D * x_t

The full-sequence scan goes through ``kernels.mamba2_ssd.ssd``: on a CUDA
tensor the Hopper kernel (K5), on a CPU tensor its plain chunked version.
(The JAX model runs its own ``ssd_chunked``; the Pallas kernel computes the
same math.)  The one-token step is plain torch, as in JAX.

Two numeric notes.  The causal depthwise conv is JAX's sum of shifted
products, not ``F.conv1d``: a float32 convolution on the card goes through
cuDNN in TF32 by default, which gives other numbers.  ``F.softplus``
returns x itself above its threshold of 20 where ``jax.nn.softplus`` is
exact; the two differ there by log1p(exp(-x)) < 2.1e-9.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_ssd import ssd
from repro_torch.models.layers import compute_dtype, dense_init


def mamba2_dims(cfg: ModelConfig):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    heads = inner // s.head_dim
    return inner, heads, s.head_dim, s.state_size


def init_mamba2_layer(gen: torch.Generator,
                      cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d = cfg.d_model
    inner, H, P, N = mamba2_dims(cfg)
    conv_ch = inner + 2 * N                      # x, B, C share the conv
    dt = compute_dtype(cfg)
    dev = gen.device
    f32 = torch.float32
    proj_out = 2 * inner + 2 * N + H             # z, xBC, dt
    return {
        "in_proj": dense_init(gen, (d, proj_out), dt),
        "conv_w": dense_init(gen, (s.conv_kernel, conv_ch), dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "d_skip": torch.ones((H,), dtype=f32, device=dev),
        "gn_scale": torch.ones((inner,), dtype=f32, device=dev),
        "out_proj": dense_init(gen, (inner, d), dt),
    }


def ssd_step(x, dt, A, B, C, h):
    """Single step. x (Bt,H,P); dt (Bt,H); B,C (Bt,N); h (Bt,H,P,N)."""
    dA = torch.exp(dt * A)                                 # (Bt,H)
    h_new = (dA[..., None, None] * h
             + (dt[..., None] * x)[..., None] * B[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h_new, C)
    return y, h_new


def _split_proj(z_xbc_dt, cfg: ModelConfig):
    inner, H, P, N = mamba2_dims(cfg)
    return torch.split(z_xbc_dt, [inner, inner + 2 * N, H], dim=-1)


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv over time as a sum of K shifted products.
    xBC (B,T,C); conv_w (K,C); conv_state (B,K-1,C) holds the last K-1
    inputs of the previous segment.  Returns (out (B,T,C), new state)."""
    K = conv_w.shape[0]
    B, T, C = xBC.shape
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, C), dtype=xBC.dtype,
                                 device=xBC.device)
    xpad = torch.cat([conv_state, xBC], dim=1)             # (B,T+K-1,C)
    out = sum(xpad[:, i:i + T] * conv_w[i] for i in range(K))
    new_state = xpad[:, -(K - 1):] if K > 1 else conv_state
    return out + conv_b, new_state


def _gated_rms(y, z, p, dtype):
    """y (..., inner) float32 gated by silu(z), RMS-normalised, scaled."""
    y = y * F.silu(z.float())
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-5)
    return (y * p["gn_scale"]).to(dtype)


def mamba2_full(p, cfg: ModelConfig, x, conv_state, ssd_state, lengths=None):
    """x (B,T,D) -> (out (B,T,D), new conv_state, new ssd_state).

    ``lengths`` (B,) makes a ragged prefill exact: pad steps get dt=0
    (state decay 1, no input) and the conv window is gathered at each
    row's last valid position."""
    inner, H, P, N = mamba2_dims(cfg)
    B_, T, D = x.shape
    z, xBC, dtp = _split_proj(x @ p["in_proj"], cfg)
    K = p["conv_w"].shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B_, K - 1, xBC.shape[-1]), dtype=xBC.dtype,
                                 device=x.device)
    xBC_conv, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                      conv_state)
    if lengths is not None:
        # the K-1 inputs ending at each row's last valid token, in the
        # coordinates of cat([conv_state, xBC])
        xpad = torch.cat([conv_state, xBC], dim=1)
        idx = (lengths.long()[:, None]
               + torch.arange(K - 1, device=x.device)[None, :])
        new_conv = torch.gather(
            xpad, 1, idx[:, :, None].expand(-1, -1, xpad.shape[-1]))
    xin, Bmat, Cmat = torch.split(F.silu(xBC_conv), [inner, N, N], dim=-1)
    dt = F.softplus(dtp.float() + p["dt_bias"])                  # (B,T,H)
    if lengths is not None:
        valid = (torch.arange(T, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])
        dt = dt * valid[:, :, None]
    A = -torch.exp(p["a_log"])                                    # (H,)
    xh = xin.reshape(B_, T, H, P).float()
    y, h_T = ssd(xh, dt, A, Bmat.float(), Cmat.float(), ssd_state)
    y = (y + p["d_skip"][:, None] * xh).reshape(B_, T, inner)
    return _gated_rms(y, z, p, x.dtype) @ p["out_proj"], new_conv, h_T


def mamba2_step(p, cfg: ModelConfig, x1, conv_state, ssd_state):
    """Single-token step. x1 (B,1,D)."""
    inner, H, P, N = mamba2_dims(cfg)
    B_ = x1.shape[0]
    z, xBC, dtp = _split_proj(x1 @ p["in_proj"], cfg)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xin, Bmat, Cmat = torch.split(F.silu(xBC)[:, 0], [inner, N, N], dim=-1)
    dt = F.softplus(dtp[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    xh = xin.reshape(B_, H, P).float()
    y, h_new = ssd_step(xh, dt, A, Bmat.float(), Cmat.float(), ssd_state)
    y = (y + p["d_skip"][:, None] * xh).reshape(B_, 1, inner)
    return _gated_rms(y, z, p, x1.dtype) @ p["out_proj"], new_conv, h_new


def init_mamba2_state(cfg: ModelConfig, num_layers: int, batch: int,
                      device=None) -> Dict[str, torch.Tensor]:
    inner, H, P, N = mamba2_dims(cfg)
    K = cfg.ssm.conv_kernel
    dt = compute_dtype(cfg)
    return {
        "conv": torch.zeros((num_layers, batch, K - 1, inner + 2 * N),
                            dtype=dt, device=device),
        "ssd": torch.zeros((num_layers, batch, H, P, N), dtype=torch.float32,
                           device=device),
    }
