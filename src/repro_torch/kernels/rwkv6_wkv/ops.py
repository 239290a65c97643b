"""WKV-6 wrapper in the model layout: r/k/v/logw (B,T,H,N), u (H,N),
s0 (B,H,N,N) -> (y (B,T,H,N), s_T (B,H,N,N)), all float32.

CPU tensors take the plain version (``ref.wkv6_plain``); CUDA tensors
launch a Hopper kernel in ``csrc/rwkv6_wkv.cu`` or raise.  The kernels
read the model layout through strides and treat steps past T as k=v=0,
logw=0 themselves, so there is no transpose and no padded copy (the TPU
wrapper moved the head axis of all four inputs and padded T).

``tensor_core_path`` picks the kernel by shape: N = 64 with 16-byte
aligned rows (the model's shapes) take the tensor-core kernel
(``wkv6_tc_fwd``), everything else the CUDA-core kernel (``wkv6_fwd``).

Where autograd needs a gradient (grad mode on and some CUDA input
requiring one), the call goes through ``Wkv6Fn``: the forward launch as
above, and a backward of two kernels in ``csrc/rwkv6_wkv_bwd.cu``
(``wkv6_bwd``), chosen by the same shape test (and dy's rows aligned too).
On the tensor-core route one kernel runs the two chunk-boundary scans (the
state at every chunk's start, the adjoint at every chunk's end) and one
takes every chunk's terms in parallel, a block per (chunk, head, batch
row); on the other, one rebuilds the chunk states and one runs the
adjoint backward over the chunks.  CPU tensors take
``ref.wkv6_bwd_plain``.  Both sources include the TF32 x 3 helpers of
``csrc/wkv_mma.cuh``.

Meta tensors (the dry-run) are checked and given the CUDA path's outputs
and scratch (the backward's boundary tensors too), and nothing is
launched.  ``wkv6_cost`` and ``wkv6_bwd_cost`` give a launch's operations
and bytes; each call reports its products' flops and its bytes to an
active ``analysis.costs.Counter``."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.analysis import costs
from repro_torch.kernels.common import (cdiv, check_cuda_status, data_ptr,
                                        float_rows, is_cuda, is_meta,
                                        SHARED_CSRC, load_library,
                                        rows_aligned16, stream_ptr)
from repro_torch.kernels.rwkv6_wkv.ref import CHUNK, wkv6_bwd_plain, wkv6_plain

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "rwkv6_wkv.cu"
BWD_SOURCE = CSRC / "rwkv6_wkv_bwd.cu"
# included by both sources (the first includes the second)
HEADERS = (CSRC / "wkv_mma.cuh", SHARED_CSRC / "tf32x3.cuh")
MAX_N = 64          # kMaxN in the sources
TC_N = 64           # kDim: N of the tensor-core kernel
# the device kernels a call may launch (torch.profiler names)
KERNEL_NAMES = ("wkv6_kernel", "wkv6_tc_kernel")
# the tensor-core route's backward kernels (the model's shapes)
BWD_KERNEL_NAMES = ("wkv6_bwd_scan_kernel", "wkv6_bwd_chunk_kernel")
SUBCHUNK = 8        # the tensor-core forward's factored sub-chunk


def wkv6_cost(B: int, T: int, H: int, N: int) -> costs.Cost:
    """One forward launch, fp32.  ``flops``: every operation of the chunked
    WKV (each exp one), per chunk and head: A off the diagonal (c(c-1)/2 N:
    two products, a sum, a difference, an exp), its diagonal, A.v,
    r exp(Lprev) S, the decayed k and the state update.  ``products``:
    per chunk and head A's dot products over s < t, A.v over s <= t,
    (r o exp(Lprev)) S and the state update (the tensor-core kernel takes
    all but A's SUBCHUNK-step diagonal blocks on tensor cores, those on
    the fly); ``other`` the rest: the diagonal blocks' decays (an exp, a
    difference and a product per (t, s < t, n)), the bonus, the factored
    blocks' decay factors (an exp, a difference, a product each), the
    cumulative sums and the state's decay.  ``nbytes``: r, k, v, logw, u and s0 read, y and
    s_T written."""
    c, sub = CHUNK, SUBCHUNK
    nc = cdiv(T, c)
    per = (5 * c * (c - 1) // 2 * N + 3 * c * N + c * (c + 1) * N
           + 2 * c * N * N + 6 * c * N + N * N * (2 * c + 2))
    diag_pairs = (c // sub) * sub * (sub - 1) // 2
    off_pairs = c * (c - 1) // 2 - diag_pairs
    factor_rows = sum(c - sub * (i + 1) for i in range(c // sub - 1))
    products = (2 * N * (off_pairs + diag_pairs) + c * (c + 1) * N
                + 2 * c * N * N + 2 * c * N * N)
    other = (3 * N * diag_pairs + 3 * c * N
             + 3 * N * (factor_rows + (c // sub - 1) * sub)
             + 2 * c * N + 3 * c * N + c * N + 2 * N * N + N)
    return costs.Cost(B * H * nc * per,
                      4 * (5 * B * T * H * N + H * N + 2 * B * H * N * N),
                      B * H * nc * products, B * H * nc * other)


def wkv6_bwd_cost(B: int, T: int, H: int, N: int) -> costs.Cost:
    """One backward launch, fp32.  ``flops``: per chunk and head the
    states pass (cumulative sum, decayed k, update), the anchor, the decay
    D = exp(Lprev_t - L_s) once per (t, s < t, n) (the kernel takes it anew
    for each of its three uses; the function needs it once), A and Bd, the
    decayed k and r, dv, dr' and dk' (three operations per (t, s < t, n)
    each), the bonus and dlogw, the adjoint's update; and du's sum over
    the batch.  ``products``: the tensor-core backward's, per chunk and
    head the two boundary scans' state products, Bd = dy v^T over s <= t,
    A's dot products over s < t, dv (A^T dy and the decayed k against G),
    and dr' and dk' (their sums over the pairs s < t, S dy and G v);
    ``other`` the rest.  ``nbytes``: r, k, v, logw, dy, u and s0 read; dr,
    dk, dv, dlogw, du and ds0 written (no dsT, as training calls it)."""
    c = CHUNK
    nc = cdiv(T, c)
    pairs = c * (c - 1) // 2
    per = (4 * c * N + N * N * (2 * c + 2)          # states pass
           + 2 * N * N + 2 * c * N                  # anchor, cumsums
           + 2 * N * pairs                          # D
           + 3 * N * pairs + 3 * c * N + N * c * (c + 1)   # A, Bd
           + 5 * c * N                              # kd, rp
           + c * (c + 1) * N + 2 * c * N * N        # dv
           + 2 * (3 * N * pairs + 2 * c * N * N + 4 * c * N)  # dr', dk'
           + 12 * c * N + N * N * (2 * c + 2))      # finalize, adjoint
    flops = B * H * nc * per + B * H * N
    products = B * H * nc * (10 * c * N * N + 2 * c * (c + 1) * N
                             + 6 * N * pairs)
    return costs.Cost(flops,
                      4 * (9 * B * T * H * N + 2 * H * N + 2 * B * H * N * N),
                      products, flops - products)


def build() -> ctypes.CDLL:
    """Compile (once per process, cached on disk) and bind the kernels."""
    lib = load_library("rwkv6_wkv", [SOURCE], HEADERS)
    lib.wkv6_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                             + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
    lib.wkv6_tc_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                                + [ctypes.c_longlong] * 15
                                + [ctypes.c_void_p])
    lib.wkv6_fwd.restype = lib.wkv6_tc_fwd.restype = ctypes.c_int
    return lib


def build_bwd() -> ctypes.CDLL:
    """Compile and bind the backward kernels (a library of their own, so
    the two sources build in parallel)."""
    lib = load_library("rwkv6_wkv_bwd", [BWD_SOURCE], HEADERS)
    lib.wkv6_bwd.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                             + [ctypes.c_longlong] * 15 + [ctypes.c_int]
                             + [ctypes.c_void_p])
    lib.wkv6_bwd.restype = ctypes.c_int
    return lib


def tensor_core_path(r, k, v, logw) -> bool:
    """Whether a launch takes the tensor-core kernel: float32 inputs (as
    the wrapper passes them) with N = TC_N and every row start 16-byte
    aligned.  Everything else takes the CUDA-core kernel."""
    return (r.shape[-1] == TC_N
            and all(rows_aligned16(t) for t in (r, k, v, logw)))


def _check(r, k, v, logw, u, s0):
    """Validate CUDA inputs the kernels take."""
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


def _forward(r, k, v, logw, u, s0):
    """One launch of the forward kernel on checked CUDA inputs."""
    B, T, H, N = r.shape
    r, k, v, logw = (float_rows(t) for t in (r, k, v, logw))
    u = u.float().contiguous()
    s0 = s0.float().contiguous()
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if r.is_meta:
        return y, sT
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


def wkv6(r, k, v, logw, u, s0):
    """The RWKV-6 recurrence over a sequence; see ``ref.wkv6_plain``.
    Differentiable (through the backward kernels on CUDA)."""
    with costs.recording("wkv6", lambda: wkv6_cost(*r.shape)):
        if (not is_meta(r, k, v, logw, u, s0)
                and not is_cuda(r, k, v, logw, u, s0)):
            return wkv6_plain(r, k, v, logw, u, s0)
        _check(r, k, v, logw, u, s0)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, logw, u, s0)):
            return Wkv6Fn.apply(r, k, v, logw, u, s0)
        return _forward(r, k, v, logw, u, s0)


wkv6.launches = 0


def wkv6_bwd(r, k, v, logw, u, s0, dy, dsT=None):
    """The gradients (dr, dk, dv, dlogw (B,T,H,N), du (H,N), ds0
    (B,H,N,N)) of ``wkv6``'s (y, s_T) given dy and dsT (either may be
    None: zero), float32; see ``csrc/rwkv6_wkv_bwd.cu``.  CPU tensors take
    ``ref.wkv6_bwd_plain``."""
    given = [t for t in (r, k, v, logw, u, s0, dy, dsT) if t is not None]
    with costs.recording("wkv6_bwd", lambda: wkv6_bwd_cost(*r.shape)):
        if not is_meta(*given) and not is_cuda(*given):
            return wkv6_bwd_plain(r, k, v, logw, u, s0, dy, dsT)
        return _backward(r, k, v, logw, u, s0, dy, dsT)


def _backward(r, k, v, logw, u, s0, dy, dsT):
    """One launch of the backward kernels on CUDA (or meta) inputs."""
    _check(r, k, v, logw, u, s0)
    B, T, H, N = r.shape
    for name, t, shape in (("dy", dy, r.shape), ("dsT", dsT, s0.shape)):
        if t is not None and t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {tuple(shape)}")
    dev = r.device
    r, k, v, logw = (float_rows(t) for t in (r, k, v, logw))
    dy = (torch.zeros((B, T, H, N), dtype=torch.float32, device=dev)
          if dy is None else float_rows(dy))
    u = u.float().contiguous()
    s0 = s0.float().contiguous()
    dsT = None if dsT is None else dsT.float().contiguous()
    tc = tensor_core_path(r, k, v, logw) and rows_aligned16(dy)
    f32 = dict(dtype=torch.float32, device=dev)
    nc = cdiv(T, CHUNK)
    # the state at every chunk's start and at the end; on the tensor-core
    # route also the adjoint at every chunk's end (entry 0: ds0)
    states = torch.empty((B, H, nc + 1, N, N), **f32)
    adj = torch.empty((B, H, nc + 1, N, N), **f32) if tc else None
    dr, dk, dv, dlogw = (torch.empty((B, T, H, N), **f32) for _ in range(4))
    # du's partial rows: one per (b, chunk, h) on the tensor-core route,
    # one per (b, h) on the other
    du_part = torch.empty((B, nc if tc else 1, H, N), **f32)
    ds0 = None if tc else torch.empty((B, H, N, N), **f32)
    if not r.is_meta:
        _launch_bwd(r, k, v, logw, u, s0, dy, dsT, states, adj, dr, dk, dv,
                    dlogw, du_part, ds0, tc)
    return (dr, dk, dv, dlogw, du_part.sum((0, 1)),
            adj[:, :, 0].clone() if tc else ds0)


def _launch_bwd(r, k, v, logw, u, s0, dy, dsT, states, adj, dr, dk, dv,
                dlogw, du_part, ds0, tc):
    B, T, H, N = r.shape
    dev = r.device
    lib = build_bwd()
    status = lib.wkv6_bwd(
        *(data_ptr(t) for t in (r, k, v, logw, u, s0, dy, dsT, states, adj,
                                dr, dk, dv, dlogw, du_part, ds0)),
        B, T, H, N, *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *logw.stride()[:3], *dy.stride()[:3], int(tc), stream_ptr(dev))
    check_cuda_status(status, "wkv6_bwd")
    wkv6_bwd.launches += 1


wkv6_bwd.launches = 0


class Wkv6Fn(torch.autograd.Function):
    """K4's forward and its backward kernels as one differentiable op on
    CUDA tensors; the forward saves its inputs only (the backward rebuilds
    the chunk states)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        y, sT = _forward(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        ctx.set_materialize_grads(False)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        grads = wkv6_bwd(*ctx.saved_tensors, dy, dsT)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
