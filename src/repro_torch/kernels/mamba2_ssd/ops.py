"""SSD wrapper in the model layout: x (B,T,H,P), dt (B,T,H), A (H,),
Bm/Cm (B,T,N), h0 (B,H,P,N) -> (y (B,T,H,P), h_T (B,H,P,N)), float32.

CPU tensors take the plain version (``ref.ssd_plain``); CUDA tensors
launch a Hopper kernel in ``csrc/mamba2_ssd.cu`` or raise.  The kernels
read the model layout through strides (x may be a view of the conv
output), form dA = dt * A themselves and treat steps past T as dt=0, so
there is no transpose, no dA tensor and no padded copy (the TPU wrapper
moved the head axis of x and dt, built dA and padded all five inputs).

``tensor_core_path`` picks the kernel by shape: P = N = 64 with 16-byte
aligned rows (the model's shapes) take the tensor-core kernel
(``ssd_tc_fwd``: a G = C B^T pass, then the scan), everything else the
CUDA-core kernel (``ssd_fwd``)."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.common import (cdiv, check_cuda_status, data_ptr,
                                        float_rows, is_cuda, load_library,
                                        refuse_grad, rows_aligned16,
                                        stream_ptr)
from repro_torch.kernels.mamba2_ssd.ref import CHUNK, ssd_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba2_ssd.cu"
MAX_DIM = 64        # kMaxP and kMaxN in the source
TC_DIM = 64         # kDim: P and N of the tensor-core kernel
# the device kernels a call may launch (torch.profiler names)
KERNEL_NAMES = ("ssd_kernel", "ssd_gram_kernel", "ssd_tc_kernel")


def build() -> ctypes.CDLL:
    """Compile (once per process, cached on disk) and bind the kernels."""
    lib = load_library("mamba2_ssd", [SOURCE])
    lib.ssd_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
    lib.ssd_tc_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                               + [ctypes.c_longlong] * 13
                               + [ctypes.c_void_p])
    lib.ssd_fwd.restype = lib.ssd_tc_fwd.restype = ctypes.c_int
    return lib


def tensor_core_path(x, Bm, Cm) -> bool:
    """Whether a launch takes the tensor-core kernel: float32 x, Bm and Cm
    (as the wrapper passes them) with P = N = TC_DIM and every row start
    16-byte aligned.  Everything else takes the CUDA-core kernel."""
    return (x.shape[-1] == TC_DIM and Bm.shape[-1] == TC_DIM
            and all(rows_aligned16(t) for t in (x, Bm, Cm)))


def ssd(x, dt, A, Bm, Cm, h0):
    """The Mamba-2 SSD scan over a sequence; see ``ref.ssd_plain``."""
    if not is_cuda(x, dt, A, Bm, Cm, h0):
        return ssd_plain(x, dt, A, Bm, Cm, h0)
    refuse_grad("ssd", x, dt, A, Bm, Cm, h0)
    if x.dim() != 4:
        raise ValueError(f"ssd takes x (B,T,H,P), got {tuple(x.shape)}")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (B, T, H) or A.shape != (H,) or Bm.shape != (B, T, N)
            or Cm.shape != Bm.shape or h0.shape != (B, H, P, N)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
            f"{tuple(Cm.shape)}, h0 {tuple(h0.shape)}")
    if P > MAX_DIM or N > MAX_DIM or T < 1:
        raise ValueError(f"ssd kernel takes P, N <= {MAX_DIM} and T >= 1, "
                         f"got P={P}, N={N}, T={T}")
    if B > 65535 or H > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
    x, Bm, Cm = (float_rows(t) for t in (x, Bm, Cm))
    dt = dt.float()
    A = A.float().contiguous()
    h0 = h0.float().contiguous()
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=x.device)
    hT = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    lib = build()
    strides = (*x.stride()[:3], *dt.stride(), Bm.stride(0), Bm.stride(1),
               Cm.stride(0), Cm.stride(1), *y.stride()[:3])
    if tensor_core_path(x, Bm, Cm):
        G = torch.empty((B, cdiv(T, CHUNK), CHUNK, CHUNK),
                        dtype=torch.float32, device=x.device)
        status = lib.ssd_tc_fwd(
            data_ptr(x), data_ptr(dt), data_ptr(A), data_ptr(Bm),
            data_ptr(Cm), data_ptr(h0), data_ptr(G), data_ptr(y),
            data_ptr(hT), B, T, H, *strides, stream_ptr(x.device))
    else:
        status = lib.ssd_fwd(
            data_ptr(x), data_ptr(dt), data_ptr(A), data_ptr(Bm),
            data_ptr(Cm), data_ptr(h0), data_ptr(y), data_ptr(hT), B, T, H,
            P, N, *strides, stream_ptr(x.device))
    check_cuda_status(status, "ssd")
    ssd.launches += 1
    return y, hT


ssd.launches = 0
