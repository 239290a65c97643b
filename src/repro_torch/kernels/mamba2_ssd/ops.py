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
heads, batch row).  CPU tensors take ``ref.ssd_bwd_plain``.

Meta tensors (the dry-run) are checked and given the CUDA path's outputs
and scratch (G, the backward's boundary tensors and partials), and
nothing is launched.  ``ssd_cost`` and ``ssd_bwd_cost`` give a launch's
operations and bytes; each call reports its products' flops and its
bytes to an active ``analysis.costs.Counter``."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.analysis import costs
from repro_torch.kernels.common import (cdiv, check_cuda_status, data_ptr,
                                        float_rows, is_cuda, is_meta,
                                        SHARED_CSRC, load_library,
                                        rows_aligned16, stream_ptr)
from repro_torch.kernels.mamba2_ssd.ref import CHUNK, ssd_bwd_plain, ssd_plain

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "mamba2_ssd.cu"
BWD_SOURCE = CSRC / "mamba2_ssd_bwd.cu"
# included by both sources (the first includes the second)
HEADERS = (CSRC / "ssd_mma.cuh", SHARED_CSRC / "tf32x3.cuh")
MAX_DIM = 64        # kMaxP and kMaxN in the sources
TC_DIM = 64         # kDim: P and N of the tensor-core kernel
# the device kernels a call may launch (torch.profiler names)
KERNEL_NAMES = ("ssd_kernel", "ssd_gram_kernel", "ssd_tc_kernel")
BWD_KERNEL_NAMES = ("ssd_bwd_scan_kernel", "ssd_bwd_chunk_kernel")
HEAD_GROUP = 8      # kGroup: heads per block of the backward's chunk kernel


def ssd_cost(B: int, T: int, H: int, P: int, N: int) -> costs.Cost:
    """One forward launch, fp32.  ``flops``: every operation of the chunked
    SSD (each exp one): per (batch row, chunk) G = C B^T once (it does not
    depend on the head); per head the decay matrix, the intra-chunk
    product, C h^T, x dt and the state update.  ``products``: G over
    s <= t, and per head W (x dt), (exp(L) o C) h^T and the state update
    (the tensor-core kernel takes G, all of it, in fp32 FMAs and the rest
    on tensor cores); ``other`` the rest (W's decay, x dt, the scales, the
    state's decay, the scan).  ``nbytes``: x, dt, A, Bm, Cm and h0 read, y
    and h_T written."""
    c = CHUNK
    nc = cdiv(T, c)
    tri = c * (c + 1) // 2
    per_head = (3 * tri + 2 * tri * P + 2 * c * N * P + 3 * c * P
                + P * N * (2 * c + 2) + 2 * c)
    products = 2 * tri * P + 2 * c * N * P + 2 * c * P * N
    other = 3 * tri + 3 * c * P + c * N + 2 * P * N + 3 * c
    return costs.Cost(B * nc * (2 * tri * N + H * per_head),
                      4 * (2 * B * T * H * P + B * T * H + H + 2 * B * T * N
                           + 2 * B * H * P * N),
                      B * nc * 2 * tri * N + B * H * nc * products,
                      B * H * nc * other)


def ssd_bwd_cost(B: int, T: int, H: int, P: int, N: int) -> costs.Cost:
    """One backward launch, fp32.  ``flops``: per (batch row, chunk)
    CB = C B^T once (it does not depend on the head); per head the states
    pass, Gc B, h0^T dy, X, M, dC (M X dt once per (t, s <= t), then two
    operations per n), gx and dx, dB, the rectangle sums of dl, E, F and
    x.gx, the scans and the adjoint's update; then dB's and dC's sums over
    the heads.  ``products``: per (batch row, chunk) CB, per head the two
    boundary scans' state products, Gc B, h0^T dy, Gc^T x and X, and the
    products of dC, gx and dB over s <= t on tensor cores; ``other`` the
    rest (M, the scales, dl's terms, the sums).  ``nbytes``: x, dt, Bm,
    Cm, dy and A read; dx, ddt, dBm, dCm, dA and dh0 written (a zero h0
    and no dhT, as training calls it)."""
    c = CHUNK
    nc = cdiv(T, c)
    tri = c * (c + 1) // 2
    per_head = (P * N * (3 * c + 1) + 4 * c              # states pass
                + 4 * c * P * N + 2 * P * tri + 2 * P * N + 4 * tri
                + tri + 2 * N * tri + 2 * c * N          # dC
                + 2 * P * tri + 3 * c * P                # gx, dx
                + 2 * N * tri + 2 * c * P * N + 3 * c * N   # dB
                + c ** 3 // 2 + 2 * c * N + 4 * c * P + 8 * c
                + P * N * (3 * c + 1))                   # adjoint
    flops = (B * nc * (2 * N * tri + H * per_head) + 2 * B * T * H * N
             + B * H)
    products = (B * nc * 2 * N * tri
                + B * H * nc * (10 * c * P * N + 4 * P * tri + 4 * N * tri))
    return costs.Cost(flops,
                      4 * (3 * B * T * H * P + 2 * B * T * H + 4 * B * T * N
                           + 2 * H + 2 * B * H * P * N),
                      products, flops - products)


def _cost(fn, x, Bm):
    """``fn``'s cost of a launch on x and Bm, when asked."""
    return lambda: fn(*x.shape, Bm.shape[-1])


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
    strides = (*x.stride()[:3], *dt.stride(), Bm.stride(0), Bm.stride(1),
               Cm.stride(0), Cm.stride(1), *y.stride()[:3])
    tc = tensor_core_path(x, Bm, Cm)
    # the tensor-core kernel's G = C B^T, one (32, 32) block a (row, chunk)
    G = (torch.empty((B, cdiv(T, CHUNK), CHUNK, CHUNK), dtype=torch.float32,
                     device=x.device) if tc else None)
    if x.is_meta:
        return y, hT
    lib = build()
    if tc:
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
    with costs.recording("ssd", _cost(ssd_cost, x, Bm)):
        if (not is_meta(x, dt, A, Bm, Cm, h0)
                and not is_cuda(x, dt, A, Bm, Cm, h0)):
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
    with costs.recording("ssd_bwd", _cost(ssd_bwd_cost, x, Bm)):
        if not is_meta(*given) and not is_cuda(*given):
            return ssd_bwd_plain(x, dt, A, Bm, Cm, h0, dy, dhT)
        return _backward(x, dt, A, Bm, Cm, h0, dy, dhT)


def _backward(x, dt, A, Bm, Cm, h0, dy, dhT):
    """One launch of the backward kernels on CUDA (or meta) inputs."""
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
    if not x.is_meta:
        _launch_bwd(x, dt, A, Bm, Cm, h0, dy, dhT, states, adj, dx, ddt,
                    dA_part, dB_part, dC_part, vec)
    # the head groups' dB and dC rows and the (b, chunk) partials of dA,
    # summed in a fixed order (every head of a row shares its B and C)
    return (dx, ddt, dA_part.sum((0, 1)), dB_part.sum(2), dC_part.sum(2),
            adj[:, :, 0].clone())


def _launch_bwd(x, dt, A, Bm, Cm, h0, dy, dhT, states, adj, dx, ddt,
                dA_part, dB_part, dC_part, vec):
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device
    lib = build_bwd()
    status = lib.ssd_bwd(
        *(data_ptr(t) for t in (x, dt, A, Bm, Cm, h0, dy, dhT, states, adj,
                                dx, ddt, dA_part, dB_part, dC_part)),
        B, T, H, P, N, *x.stride()[:3], *dt.stride(), Bm.stride(0),
        Bm.stride(1), Cm.stride(0), Cm.stride(1), *dy.stride()[:3],
        int(vec), stream_ptr(dev))
    check_cuda_status(status, "ssd_bwd")
    ssd_bwd.launches += 1


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
