"""Common layers: norms, rotary embeddings, MLPs, initializers, losses.

Plain functions on tensors, params as dicts of tensors (the port of
``repro/models/layers.py``).  Norm statistics are computed in float32
regardless of the compute dtype; matmuls run in the config dtype.  RMSNorm
(with the residual add before it), RoPE on q and k and SwiGLU's
``silu(gate) * up`` take ``kernels.fused_block``'s one-pass kernels where
``fused`` says so, and their eager chains elsewhere.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fused_block import (VEC, rms_norm, rms_norm_plain,
                                             rope_plain, rope_qk,
                                             rope_qk_plain, silu_mul,
                                             silu_mul_plain)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Initializers (random numbers from a torch.Generator on the target device;
# they differ from jax.random's for the same seed)
# ---------------------------------------------------------------------------


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device: initializers then
    allocate meta tensors (keys, shapes, dtypes; no storage, no draws)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(seed: int, device) -> torch.Generator:
    """The seeded generator ``init_params`` draws from on ``device``; on
    the meta device the params come out as meta tensors (``Model.like``)."""
    device = torch.device(device)
    gen = (_MetaGenerator() if device.type == "meta"
           else torch.Generator(device=device))
    gen.manual_seed(seed)
    return gen


def dense_init(gen: torch.Generator, shape, dtype, in_axis: int = -2):
    """Truncated-normal fan-in init (stddev = 1/sqrt(fan_in)), drawn in
    float32 on the generator's device and cast to ``dtype``."""
    fan_in = shape[in_axis]
    std = 1.0 / np.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(0.02).to(dtype)


def stack_init(gen: torch.Generator, num: int, init_fn, *args
               ) -> Dict[str, torch.Tensor]:
    """``num`` draws of ``init_fn(gen, *args)`` (a flat dict of tensors)
    stacked on a leading axis: the port of ``stack_init``'s vmap over
    layers.  Each stacked tensor is allocated once and filled a draw at a
    time, so the float32 temporaries never exceed one draw's tensor."""
    stacked: Dict[str, torch.Tensor] = {}
    for i in range(num):
        for k, v in init_fn(gen, *args).items():
            if i == 0:
                stacked[k] = torch.empty((num, *v.shape), dtype=v.dtype,
                                         device=v.device)
            stacked[k][i] = v
    return stacked


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_kind == "layernorm":
        p["nbias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def fused(width: int, *tensors: torch.Tensor) -> bool:
    """Whether a call takes the fused block kernels: bfloat16 activations
    (``tensors[0]``'s dtype) whose ``width`` (the dim the kernel cuts into
    16-byte vectors) is a multiple of ``VEC``, and no gradient needed, since
    the kernels have no backward.  float32 (witness copies, encoder
    frames), other widths and training run the eager chain; the kernels'
    wrappers raise on anything else they cannot take."""
    return (tensors[0].dtype == torch.bfloat16 and width % VEC == 0
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in tensors)))


def apply_norm(p, x, cfg: ModelConfig, eps: Optional[float] = None):
    """LayerNorm or RMSNorm of x over its last dim, statistics in float32;
    an RMSNorm in one pass of ``rms_norm`` where ``fused``."""
    eps = eps or cfg.norm_eps
    if cfg.norm_kind != "layernorm":
        norm = rms_norm if fused(x.shape[-1], x, p["scale"]) else \
            rms_norm_plain
        return norm(x, p["scale"], eps)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"]
    if "nbias" in p:
        y = y + p["nbias"]
    return y.to(x.dtype)


def add_norm(p, x, residual, cfg: ModelConfig,
             eps: Optional[float] = None):
    """(x + residual, ``apply_norm`` of it): the residual add and the norm
    after it, in one pass of ``rms_norm`` where ``fused``."""
    if cfg.norm_kind != "layernorm":
        norm = rms_norm if fused(x.shape[-1], x, residual, p["scale"]) \
            else rms_norm_plain
        return norm(x, p["scale"], eps or cfg.norm_eps, residual=residual)
    x = x + residual
    return x, apply_norm(p, x, cfg, eps)


def group_norm(x, scale, bias, num_groups: int, eps: float = 1e-5):
    """GroupNorm over the channel dim (rwkv6's per-head output norm).  The
    variance is the population variance, as ``jnp.var``'s default."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split convention, not interleaved)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as a tensor on ``device``, copied there once: a copy
    from pageable host memory per call would wait for the device's queue
    to drain every layer.  Callers must not modify the tensor."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


@functools.lru_cache(maxsize=32)
def _sinusoidal_on(num: int, d: int, device: torch.device) -> torch.Tensor:
    pos = np.arange(num)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = 1.0 / (10000 ** (dim / max(d // 2 - 1, 1)))
    ang = pos * inv
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def clear_tables() -> None:
    """Drop the device copies of the rope and sinusoidal tables: the next
    call makes them anew, as a new process's first step does."""
    _rope_freqs_on.cache_clear()
    _sinusoidal_on.cache_clear()


def sinusoidal_positions(num: int, d: int, device) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (num, d), float32 on
    ``device`` (computed in float64 with numpy, as the JAX package's, and
    copied there once; callers must not modify the tensor)."""
    return _sinusoidal_on(num, d, torch.device(device))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    if theta <= 0.0:
        return x
    return rope_plain(x, positions,
                      _rope_freqs_on(x.shape[-1], float(theta), x.device))


def apply_rope_qk(q, k, positions, theta: float):
    """``apply_rope`` of q (B,S,H,hd) and of k (B,S,K,hd), the fresh
    projections of one block, in one launch of ``rope_qk`` where ``fused``:
    q and k may be rotated in place, so callers take the returned pair and
    keep no other reference to them."""
    if theta <= 0.0:
        return q, k
    hd = q.shape[-1]
    rope = rope_qk if hd % 2 == 0 and fused(hd // 2, q, k) else rope_qk_plain
    return rope(q, k, positions, _rope_freqs_on(hd, float(theta), q.device))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def matmul(x, w):
    """``x @ w`` with JAX's type promotion: operands of two float dtypes
    compute in the wider one (float32 @ bfloat16 -> float32), where
    torch's matmul raises.  The encoder-decoder's float32 frames and the
    VLM's float32 image embeddings meet bf16 weights this way."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None,
             d: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d = d or cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = compute_dtype(cfg)
    if cfg.act == "swiglu":
        p = {"w_gate": dense_init(gen, (d, ff), dt),
             "w_up": dense_init(gen, (d, ff), dt),
             "w_down": dense_init(gen, (ff, d), dt)}
    else:
        p = {"w_up": dense_init(gen, (d, ff), dt),
             "w_down": dense_init(gen, (ff, d), dt)}
    if cfg.use_bias:
        p["b_up"] = torch.zeros((ff,), dtype=dt, device=gen.device)
        p["b_down"] = torch.zeros((d,), dtype=dt, device=gen.device)
    return p


def apply_mlp(p, x, cfg: ModelConfig):
    if cfg.act == "swiglu":
        gate, up = matmul(x, p["w_gate"]), matmul(x, p["w_up"])
        act = silu_mul if fused(gate.shape[-1], gate, up) else \
            silu_mul_plain
        h = act(gate, up)
    else:
        u = matmul(x, p["w_up"])
        if "b_up" in p:
            u = u + p["b_up"]
        if cfg.act == "relu_sq":
            h = F.relu(u).square()
        else:  # gelu, tanh approximation as jax.nn.gelu's default
            h = F.gelu(u, approximate="tanh")
    out = matmul(h, p["w_down"])
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _masked_mean(nll, mask):
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def cross_entropy_loss(logits, labels, mask=None):
    """Mean masked token cross-entropy; logits in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return _masked_mean(logz - gold, mask)


def _ce_chunk(hf, head, labels, i: int, chunk: int, V: int, m, s, gold):
    """One vocab chunk of ``chunked_cross_entropy``'s online logsumexp."""
    wc = head[:, i * chunk:(i + 1) * chunk]
    logits_c = hf @ wc.float()                              # (B, S, chunk)
    # mask padded vocab entries out of the logsumexp
    col = i * chunk + torch.arange(chunk, device=hf.device)
    logits_c = torch.where(col < V, logits_c, -1e30)
    m_new = torch.maximum(m, logits_c.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(
        logits_c - m_new[..., None]).sum(dim=-1)
    # gold logit if this row's label falls in the chunk
    in_chunk = (labels >= i * chunk) & (labels < (i + 1) * chunk)
    idx = (labels - i * chunk).clamp(0, chunk - 1)
    g = logits_c.gather(-1, idx[..., None])[..., 0]
    return m_new, s, torch.where(in_chunk, g, gold)


def chunked_cross_entropy(h, head, labels, mask=None, chunk: int = 16384):
    """Cross-entropy WITHOUT materializing the (B, S, V) logits tensor.

    Walks vocab chunks with an online logsumexp, each step touching only
    (B, S, chunk); each step runs under ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint`` of the scan body), so backward re-materializes one
    chunk at a time too.  h: (B, S, D); head: (D, V); labels: (B, S) ->
    scalar mean CE."""
    from torch.utils.checkpoint import checkpoint
    B, S, _ = h.shape
    V = head.shape[1]
    nc = -(-V // chunk)
    if nc * chunk != V:
        head = F.pad(head, (0, nc * chunk - V))
    hf = h.float()
    labels = labels.long()
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=h.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    gold = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    for i in range(nc):
        m, s, gold = checkpoint(_ce_chunk, hf, head, labels, i, chunk, V, m,
                                s, gold, use_reentrant=False,
                                preserve_rng_state=False)
    return _masked_mean((m + torch.log(s)) - gold, mask)
