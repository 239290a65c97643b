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
CUDA-core kernel (``ssd_fwd``).

Where autograd needs a gradient (grad mode on and some CUDA input
requiring one), the call goes through ``SsdFn``: the forward launch as
above, and a backward of two kernels in ``csrc/mamba2_ssd_bwd.cu``
(``ssd_bwd``): one that runs the two chunk-boundary scans (the state at
every chunk's start, the adjoint at every chunk's end), and one that takes
every chunk's terms in parallel, a block per (chunk, group of HEAD_GROUP
heads, batch row).  CPU tensors take ``ref.ssd_bwd_plain``."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.common import (cdiv, check_cuda_status, data_ptr,
                                        float_rows, is_cuda, load_library,
                                        rows_aligned16, stream_ptr)
from repro_torch.kernels.mamba2_ssd.ref import CHUNK, ssd_bwd_plain, ssd_plain

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "mamba2_ssd.cu"
BWD_SOURCE = CSRC / "mamba2_ssd_bwd.cu"
HEADERS = (CSRC / "ssd_mma.cuh",)   # included by both sources
MAX_DIM = 64        # kMaxP and kMaxN in the sources
TC_DIM = 64         # kDim: P and N of the tensor-core kernel
# the device kernels a call may launch (torch.profiler names)
KERNEL_NAMES = ("ssd_kernel", "ssd_gram_kernel", "ssd_tc_kernel")
BWD_KERNEL_NAMES = ("ssd_bwd_scan_kernel", "ssd_bwd_chunk_kernel")
HEAD_GROUP = 8      # kGroup: heads per block of the backward's chunk kernel


def build() -> ctypes.CDLL:
    """Compile (once per process, cached on disk) and bind the kernels."""
    lib = load_library("mamba2_ssd", [SOURCE], HEADERS)
    lib.ssd_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
    lib.ssd_tc_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                               + [ctypes.c_longlong] * 13
                               + [ctypes.c_void_p])
    lib.ssd_fwd.restype = lib.ssd_tc_fwd.restype = ctypes.c_int
    return lib


def build_bwd() -> ctypes.CDLL:
    """Compile and bind the backward kernels (a library of their own, so
    the two sources build in parallel)."""
    lib = load_library("mamba2_ssd_bwd", [BWD_SOURCE], HEADERS)
    lib.ssd_bwd.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 13 + [ctypes.c_int]
                            + [ctypes.c_void_p])
    lib.ssd_bwd.restype = ctypes.c_int
    return lib


def tensor_core_path(x, Bm, Cm) -> bool:
    """Whether a launch takes the tensor-core kernel: float32 x, Bm and Cm
    (as the wrapper passes them) with P = N = TC_DIM and every row start
    16-byte aligned.  Everything else takes the CUDA-core kernel."""
    return (x.shape[-1] == TC_DIM and Bm.shape[-1] == TC_DIM
            and all(rows_aligned16(t) for t in (x, Bm, Cm)))


def _check(x, dt, A, Bm, Cm, h0):
    """Validate CUDA inputs the kernels take."""
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


def _forward(x, dt, A, Bm, Cm, h0):
    """One launch of the forward kernels on checked CUDA inputs."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
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


def ssd(x, dt, A, Bm, Cm, h0):
    """The Mamba-2 SSD scan over a sequence; see ``ref.ssd_plain``.
    Differentiable (through the backward kernels on CUDA)."""
    if not is_cuda(x, dt, A, Bm, Cm, h0):
        return ssd_plain(x, dt, A, Bm, Cm, h0)
    _check(x, dt, A, Bm, Cm, h0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, h0)):
        return SsdFn.apply(x, dt, A, Bm, Cm, h0)
    return _forward(x, dt, A, Bm, Cm, h0)


ssd.launches = 0


def ssd_bwd(x, dt, A, Bm, Cm, h0, dy, dhT=None):
    """The gradients (dx (B,T,H,P), ddt (B,T,H), dA (H,), dBm, dCm
    (B,T,N), dh0 (B,H,P,N)) of ``ssd``'s (y, h_T) given dy and dhT (either
    may be None: zero), float32; see ``csrc/mamba2_ssd_bwd.cu``.  CPU
    tensors take ``ref.ssd_bwd_plain``."""
    given = [t for t in (x, dt, A, Bm, Cm, h0, dy, dhT) if t is not None]
    if not is_cuda(*given):
        return ssd_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dhT)
    _check(x, dt, A, Bm, Cm, h0)
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    for name, t, shape in (("dy", dy, x.shape), ("dhT", dhT, h0.shape)):
        if t is not None and t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {tuple(shape)}")
    dev = x.device
    x, Bm, Cm = (float_rows(t) for t in (x, Bm, Cm))
    dy = (torch.zeros((B, T, H, P), dtype=torch.float32, device=dev)
          if dy is None else float_rows(dy))
    dt = dt.float()
    A = A.float().contiguous()
    h0 = h0.float().contiguous()
    dhT = None if dhT is None else dhT.float().contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    nc = cdiv(T, CHUNK)
    # the state at every chunk's start and the adjoint at every chunk's
    # end (entry 0: dh0), each (B, H, nc + 1, P, N)
    states, adj = (torch.empty((B, H, nc + 1, P, N), **f32)
                   for _ in range(2))
    dx = torch.empty((B, T, H, P), **f32)
    ddt = torch.empty((B, T, H), **f32)
    dA_part = torch.empty((B, nc, H), **f32)
    groups = cdiv(H, HEAD_GROUP)
    dB_part, dC_part = (torch.empty((B, T, groups, N), **f32)
                        for _ in range(2))
    vec = (P % 4 == 0 and N % 4 == 0
           and all(rows_aligned16(t) for t in (x, dy, Bm, Cm)))
    lib = build_bwd()
    status = lib.ssd_bwd(
        *(data_ptr(t) for t in (x, dt, A, Bm, Cm, h0, dy, dhT, states, adj,
                                dx, ddt, dA_part, dB_part, dC_part)),
        B, T, H, P, N, *x.stride()[:3], *dt.stride(), Bm.stride(0),
        Bm.stride(1), Cm.stride(0), Cm.stride(1), *dy.stride()[:3],
        int(vec), stream_ptr(dev))
    check_cuda_status(status, "ssd_bwd")
    ssd_bwd.launches += 1
    # the head groups' dB and dC rows and the (b, chunk) partials of dA,
    # summed in a fixed order (every head of a row shares its B and C)
    return (dx, ddt, dA_part.sum((0, 1)), dB_part.sum(2), dC_part.sum(2),
            adj[:, :, 0].clone())


ssd_bwd.launches = 0


class SsdFn(torch.autograd.Function):
    """K5's forward and its backward kernels as one differentiable op on
    CUDA tensors; the forward saves its inputs only (the backward rebuilds
    the chunk states)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        y, hT = _forward(x, dt, A, Bm, Cm, h0)
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        grads = ssd_bwd(*ctx.saved_tensors, dy, dhT)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
