"""Flash attention wrapper in model layout: q (B,S,H,hd), k/v (B,Skv,K,hd).

CPU tensors take the plain version (``ref.flash_attention_plain``); CUDA
tensors launch the Hopper kernel in ``csrc/flash_attention.cu`` or raise.
The kernel reads the model layout through strides, so there is no
transpose and no padding copy (unlike the TPU wrapper, which moves the head
axis and pads S to the block size)."""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.common import (check_cuda_status, data_ptr, is_cuda,
                                        load_library, stream_ptr)
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> ctypes.CDLL:
    """Compile (once per process, cached on disk) and bind the kernel."""
    lib = load_library("flash_attention", [SOURCE])
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, lengths=None):
    """Attention of q (B,S,H,hd) over k/v (B,Skv,K,hd); see
    ``csrc/flash_attention.cu``.  S and Skv are independent (Skv != S is
    cross-attention), as in the TPU kernel.

    ``lengths`` (B,) gives each row's valid key count, read as
    ``min(lengths[b], Skv)`` (ragged right-padded batches); query and key
    positions both count from 0, so ``causal`` keeps ``kpos <= qpos`` and
    ``window`` keeps ``qpos - window < kpos``.  Returns (B,S,H,hd) in q's
    dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    tensors = (q, k, v) if lengths is None else (q, k, v, lengths)
    if not is_cuda(*tensors):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     lengths=lengths)
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
    if lengths is not None:
        if lengths.shape != (B,):
            raise ValueError(f"lengths must be ({B},), got "
                             f"{tuple(lengths.shape)}")
        lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib = build()
    status = lib.flash_attention_fwd(
        data_ptr(q), data_ptr(k), data_ptr(v), data_ptr(out),
        data_ptr(lengths), _DTYPES[q.dtype], B, S, Skv, H, K, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(causal), int(window or 0),
        1.0 / (hd ** 0.5), stream_ptr(q.device))
    check_cuda_status(status, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
