"""WKV-6 wrapper in the model layout: r/k/v/logw (B,T,H,N), u (H,N),
s0 (B,H,N,N) -> (y (B,T,H,N), s_T (B,H,N,N)), all float32.

CPU tensors take the plain version (``ref.wkv6_plain``); CUDA tensors
launch a Hopper kernel in ``csrc/rwkv6_wkv.cu`` or raise.  The kernels
read the model layout through strides and treat steps past T as k=v=0,
logw=0 themselves, so there is no transpose and no padded copy (the TPU
wrapper moved the head axis of all four inputs and padded T).

``tensor_core_path`` picks the kernel by shape: N = 64 with 16-byte
aligned rows (the model's shapes) take the tensor-core kernel
(``wkv6_tc_fwd``), everything else the CUDA-core kernel (``wkv6_fwd``)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.common import (check_cuda_status, data_ptr,
                                        float_rows, is_cuda, load_library,
                                        refuse_grad, rows_aligned16,
                                        stream_ptr)
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_wkv.cu"
MAX_N = 64          # kMaxN in the source
TC_N = 64           # kDim: N of the tensor-core kernel
# the device kernels a call may launch (torch.profiler names)
KERNEL_NAMES = ("wkv6_kernel", "wkv6_tc_kernel")


def build() -> ctypes.CDLL:
    """Compile (once per process, cached on disk) and bind the kernels."""
    lib = load_library("rwkv6_wkv", [SOURCE])
    lib.wkv6_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                             + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
    lib.wkv6_tc_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                                + [ctypes.c_longlong] * 15
                                + [ctypes.c_void_p])
    lib.wkv6_fwd.restype = lib.wkv6_tc_fwd.restype = ctypes.c_int
    return lib


def tensor_core_path(r, k, v, logw) -> bool:
    """Whether a launch takes the tensor-core kernel: float32 inputs (as
    the wrapper passes them) with N = TC_N and every row start 16-byte
    aligned.  Everything else takes the CUDA-core kernel."""
    return (r.shape[-1] == TC_N
            and all(rows_aligned16(t) for t in (r, k, v, logw)))


def wkv6(r, k, v, logw, u, s0):
    """The RWKV-6 recurrence over a sequence; see ``ref.wkv6_plain``."""
    if not is_cuda(r, k, v, logw, u, s0):
        return wkv6_plain(r, k, v, logw, u, s0)
    refuse_grad("wkv6", r, k, v, logw, u, s0)
    if r.dim() != 4:
        raise ValueError(f"wkv6 takes (B,T,H,N) inputs, got r "
                         f"{tuple(r.shape)}")
    B, T, H, N = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r "
                             f"{tuple(r.shape)}")
    if u.shape != (H, N) or s0.shape != (B, H, N, N):
        raise ValueError(f"u {tuple(u.shape)} / s0 {tuple(s0.shape)} do not "
                         f"match (B,T,H,N)={tuple(r.shape)}")
    if N > MAX_N or T < 1:
        raise ValueError(f"wkv6 kernel takes 1 <= N <= {MAX_N} and T >= 1, "
                         f"got N={N}, T={T}")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
    r, k, v, logw = (float_rows(t) for t in (r, k, v, logw))
    u = u.float().contiguous()
    s0 = s0.float().contiguous()
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    lib = build()
    ptrs = [data_ptr(t) for t in (r, k, v, logw, u, s0, y, sT)]
    strides = (*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *logw.stride()[:3], *y.stride()[:3])
    if tensor_core_path(r, k, v, logw):
        status = lib.wkv6_tc_fwd(*ptrs, B, T, H, *strides,
                                 stream_ptr(r.device))
    else:
        status = lib.wkv6_fwd(*ptrs, B, T, H, N, *strides,
                              stream_ptr(r.device))
    check_cuda_status(status, "wkv6")
    wkv6.launches += 1
    return y, sT


wkv6.launches = 0
