"""Flash attention wrapper in model layout: q (B,S,H,hd), k/v (B,Skv,K,hd).

CPU tensors take the plain version (``ref.flash_attention_plain``), which
autograd differentiates; CUDA tensors launch the Hopper kernel in
``csrc/flash_attention.cu`` or raise.  The kernel reads the model layout
through strides, so there is no transpose and no padding copy (unlike the
TPU wrapper, which moves the head axis and pads S to the block size).
Meta tensors (the dry-run) are checked and given the CUDA path's outputs
and log-sum-exp, and nothing is launched.  ``flash_attention_cost`` and
``flash_attention_bwd_cost`` give a launch's flops and bytes; each call
reports them to an active ``analysis.costs.Counter``.

Where autograd needs a gradient (grad mode on and some CUDA input
requiring one), the call goes through ``FlashAttentionFn``: the forward
kernel also writes each row's log-sum-exp, and the backward runs the
backward kernel of ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``).  Otherwise the serving launch runs as it is.

``tensor_core_path`` picks each launch's route from shapes, dtype and
alignment and passes it to the C entries: head dims 64-128 with 16-byte
aligned rows run on the tensor cores (bf16 on wgmma, float32 as TF32 x 3
on mma.sync), the rest on the CUDA-core kernels.  Each wrapper records the
route of its last launch (``flash_attention.tensor_cores``,
``flash_attention_bwd.tensor_cores``)."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import costs
from repro_torch.kernels.common import (SHARED_CSRC, check_cuda_status,
                                        data_ptr, is_cuda, is_meta,
                                        load_library, rows_aligned,
                                        stream_ptr)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_plain,
                                                     flash_attention_plain)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"
HEADER = CSRC / "sm90.cuh"      # the sm_90a helpers both sources include
# the headers both sources include (sm90.cuh includes the TF32 x 3 helpers)
HEADERS = (HEADER, SHARED_CSRC / "tf32x3.cuh")
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 80, 96, 128)   # the tensor-core kernels' head dims
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> ctypes.CDLL:
    """Compile (once per process, cached on disk) and bind the kernel."""
    lib = load_library("flash_attention", [SOURCE], HEADERS)
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return lib


def build_bwd() -> ctypes.CDLL:
    """Compile and bind the backward kernel (a library of its own, so the
    two sources build in parallel)."""
    lib = load_library("flash_attention_bwd", [BWD_SOURCE], HEADERS)
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 24
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    return lib


def tensor_core_path(q, *others) -> bool:
    """Whether a launch takes K1's tensor-core kernels: head_dim in
    ``TC_HEAD_DIMS`` and every row of q and ``others`` (k, v; the backward
    also dO) 16-byte aligned; float32 runs them as TF32 x 3 on mma.sync,
    bfloat16 on wgmma.  Everything else (hd 32 or 256, an odd stride, an
    offset view) takes the CUDA-core kernels.  The C entries take the
    choice as their ``tc`` argument and refuse inputs it cannot hold."""
    return (q.shape[-1] in TC_HEAD_DIMS
            and all(rows_aligned(t) for t in (q, *others)))


@functools.lru_cache(maxsize=256)
def visible_pairs(S: int, Skv: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs of one batch row that the mask keeps at full
    lengths: keys kpos < Skv with kpos <= qpos where ``causal`` and
    kpos > qpos - window where ``window``."""
    qpos = np.arange(S, dtype=np.int64)
    hi = np.minimum(qpos, Skv - 1) if causal else np.full(S, Skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(S,
                                                                   np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention_cost(B: int, S: int, Skv: int, H: int, K: int, hd: int,
                         itemsize: int, *, causal: bool = True,
                         window: Optional[int] = None) -> costs.Cost:
    """One forward launch: the products' flops (Q K^T and P V, 4 hd a
    visible pair a head, every row at full length: a launch's shapes say
    no more) and the bytes of q, k, v read and the output written."""
    pairs = B * visible_pairs(S, Skv, causal, window)
    return costs.Cost(4 * hd * H * pairs,
                      itemsize * (2 * B * S * H * hd + 2 * B * Skv * K * hd))


def flash_attention_bwd_cost(B: int, S: int, Skv: int, H: int, K: int,
                             hd: int, itemsize: int, *, causal: bool = True,
                             window: Optional[int] = None) -> costs.Cost:
    """One backward launch: 2.5x the forward's products (S again, dP, dV,
    dK and dQ) and the bytes of q, k, v, o and dO read, dq, dk and dv
    written."""
    fwd = flash_attention_cost(B, S, Skv, H, K, hd, itemsize, causal=causal,
                               window=window)
    return costs.Cost(2.5 * fwd.flops,
                      itemsize * (4 * B * S * H * hd + 4 * B * Skv * K * hd))


def _cost(fn, q, k, causal, window):
    """``fn``'s cost of a launch on q and k, when asked (shapes unchecked
    until then)."""
    def cost():
        B, S, H, hd = q.shape
        return fn(B, S, k.shape[1], H, k.shape[2], hd, q.element_size(),
                  causal=causal, window=window)
    return cost


def _check(q, k, v, lengths):
    """Validate CUDA inputs the kernels take; returns int32 lengths."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-d q (B,S,H,hd) and "
                         "k/v (B,Skv,K,hd)")
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, K, hd) or v.shape != k.shape or Skv < 1:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % K:
        raise ValueError(f"{H} query heads not divisible by {K} kv heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q/k/v must be contiguous")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
    if lengths is None:
        return None
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    return lengths.to(torch.int32).contiguous()


def _forward(q, k, v, causal, window, lengths, with_lse: bool):
    """One launch of the forward kernel: out, and the (B,H,S) fp32 lse
    where ``with_lse``, else None."""
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.is_meta:
        return out, lse
    tc = tensor_core_path(q, k, v)
    lib = build()
    status = lib.flash_attention_fwd(
        data_ptr(q), data_ptr(k), data_ptr(v), data_ptr(out), data_ptr(lse),
        data_ptr(lengths), _DTYPES[q.dtype], B, S, Skv, H, K, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), int(window or 0),
        1.0 / (hd ** 0.5), stream_ptr(q.device), int(tc))
    check_cuda_status(status, "flash_attention")
    flash_attention.launches += 1
    flash_attention.tensor_cores = tc
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, lengths=None):
    """Attention of q (B,S,H,hd) over k/v (B,Skv,K,hd); see
    ``csrc/flash_attention.cu``.  S and Skv are independent (Skv != S is
    cross-attention), as in the TPU kernel.

    ``lengths`` (B,) gives each row's valid key count, read as
    ``min(lengths[b], Skv)`` (ragged right-padded batches); query and key
    positions both count from 0, so ``causal`` keeps ``kpos <= qpos`` and
    ``window`` keeps ``qpos - window < kpos``.  Returns (B,S,H,hd) in q's
    dtype; differentiable (through the backward kernel on CUDA)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    tensors = (q, k, v) if lengths is None else (q, k, v, lengths)
    with costs.recording("flash_attention",
                         _cost(flash_attention_cost, q, k, causal, window)):
        if not is_meta(*tensors) and not is_cuda(*tensors):
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, lengths=lengths)
        lengths = _check(q, k, v, lengths)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, lengths, causal, window)
        return _forward(q, k, v, causal, window, lengths,
                        with_lse=False)[0]


flash_attention.launches = 0
flash_attention.tensor_cores = None     # the last launch's path


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, lengths=None):
    """The gradients (dq, dk, dv) of ``flash_attention`` at (q, k, v) given
    its output ``o``, its (B,H,S) fp32 log-sum-exp ``lse`` and the
    output's gradient ``do``; see ``csrc/flash_attention_bwd.cu``.  CPU
    tensors take ``ref.flash_attention_bwd_plain``."""
    tensors = (q, k, v, o, lse, do) + (() if lengths is None else (lengths,))
    with costs.recording("flash_attention_bwd",
                         _cost(flash_attention_bwd_cost, q, k, causal,
                               window)):
        if not is_meta(*tensors) and not is_cuda(*tensors):
            return flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal, window=window,
                                             lengths=lengths)
        return _backward(q, k, v, o, lse, do, causal, window, lengths)


def _backward(q, k, v, o, lse, do, causal, window, lengths):
    """One launch of the backward kernels on CUDA (or meta) inputs."""
    lengths = _check(q, k, v, lengths)
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}")
    if o.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o must be {q.dtype} and lse float32, got "
                        f"{o.dtype}/{lse.dtype}")
    do = do.to(q.dtype)
    o, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (o, do))
    lse = lse.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, Skv, K, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if q.is_meta:
        return dq, dk, dv
    tc = tensor_core_path(q, k, v, do)
    lib = build_bwd()
    status = lib.flash_attention_bwd(
        data_ptr(q), data_ptr(k), data_ptr(v), data_ptr(o), data_ptr(do),
        data_ptr(lse), data_ptr(delta), data_ptr(dq), data_ptr(dk),
        data_ptr(dv), data_ptr(lengths), _DTYPES[q.dtype], B, S, Skv, H, K,
        hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3], int(causal), int(window or 0),
        1.0 / (hd ** 0.5), stream_ptr(q.device), int(tc))
    check_cuda_status(status, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tensor_cores = tc
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.tensor_cores = None   # the last call's path


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward (with its log-sum-exp) and the backward kernel as one
    differentiable op on CUDA tensors; the forward saves q, k, v, o and
    lse, nothing of size S x Skv."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, window):
        out, lse = _forward(q, k, v, causal, window, lengths, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window, lengths=lengths)
        return dq, dk, dv, None, None, None
