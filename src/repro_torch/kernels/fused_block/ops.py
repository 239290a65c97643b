"""Wrappers of the fused block kernels (``csrc/fused_block.cu``): RMSNorm
with an optional residual add before it, RoPE on q and k in one launch,
and SwiGLU's ``silu(gate) * up``.

Each wrapper follows K1's: a CPU tensor runs the plain version (``ref.py``,
the eager chain op for op); a CUDA tensor launches the kernel and bumps
the wrapper's ``launches``, or raises where the kernel cannot take the
call; a meta tensor (the dry-run) is checked the same way and gets the
outputs the card would allocate, launching nothing.  Every call is
recorded to an active ``analysis.costs.Counter`` with its cost function's
bytes (each input read once, each output written once; no products).

The kernels take bfloat16 activations (the norm's scale float32),
contiguous and 16-byte aligned, whose last dim is a whole number of
16-byte vectors (``VEC`` elements), and have no backward.  Which calls
come here is ``models/layers.py``'s choice: float32, other widths and
calls that need a gradient run the eager chain there.

RoPE rotates q and k IN PLACE on the card (the fresh projection outputs
it is given: q and k must not share memory); the plain version returns
new tensors and the meta branch q and k as they are.  Callers use the
returned pair either way."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.analysis import costs
from repro_torch.kernels.common import (check_cuda_status, data_ptr, is_cuda,
                                        is_meta, load_library, stream_ptr)
from repro_torch.kernels.fused_block.ref import (rms_norm_plain,
                                                 rope_qk_plain,
                                                 silu_mul_plain)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "fused_block.cu"
VEC = 8             # bfloat16 elements in one 16-byte vector


@functools.cache
def build() -> ctypes.CDLL:
    """Compile (once per process, cached on disk) and bind the kernels;
    bound once, since every block of every layer calls it."""
    lib = load_library("fused_block", [SOURCE])
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rms_norm_fwd.argtypes = [vp] * 5 + [ll, i, ctypes.c_float, vp]
    lib.rope_qk_fwd.argtypes = [vp, vp, vp, i, vp] + [i] * 5 + [ll, ll, vp]
    lib.silu_mul_fwd.argtypes = [vp, vp, vp, ll, vp]
    for fn in (lib.rms_norm_fwd, lib.rope_qk_fwd, lib.silu_mul_fwd):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, acts, width: int, others=()) -> None:
    """Raise unless the kernel can take the call: bfloat16 activations
    ``acts``, ``width`` (the dim the kernel cuts into vectors) a multiple
    of ``VEC``, every tensor contiguous and 16-byte aligned (a meta
    tensor's address is its offset), and no gradient needed."""
    if any(t.dtype != torch.bfloat16 for t in acts):
        raise TypeError(f"{name} takes bfloat16 activations, got "
                        f"{[t.dtype for t in acts]}")
    if width % VEC:
        raise ValueError(f"{name}: width {width} is not a multiple of {VEC}")
    if any(not t.is_contiguous() or t.data_ptr() % 16
           for t in (*acts, *others)):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (*acts, *others)):
        raise ValueError(f"{name} has no backward: an input needs a "
                         f"gradient")


# --- RMSNorm -------------------------------------------------------------------


def rms_norm_cost(rows: int, D: int, residual: bool) -> costs.Cost:
    """One launch: x (and the residual) read, y (and x + residual)
    written, each once, and the float32 scale."""
    streams = 4 if residual else 2
    return costs.Cost(0.0, 2 * streams * rows * D + 4 * D)


def rms_norm(x, scale, eps: float, residual=None):
    """RMSNorm of x over its last dim (statistics in float32) times
    ``scale``, in x's dtype; with ``residual``, of ``x + residual``
    (rounded to x's dtype, as the eager add), returning (x + residual, its
    norm) from one pass."""
    tensors = (x, scale) if residual is None else (x, scale, residual)
    D = x.shape[-1]
    rows = x.numel() // max(D, 1)
    with costs.recording("rms_norm", lambda: rms_norm_cost(
            rows, D, residual is not None)):
        meta = is_meta(*tensors)
        if not meta and not is_cuda(*tensors):
            return rms_norm_plain(x, scale, eps, residual)
        acts = (x,) if residual is None else (x, residual)
        _check("rms_norm", acts, D, (scale,))
        if scale.dtype != torch.float32 or tuple(scale.shape) != (D,):
            raise TypeError(f"rms_norm takes a float32 ({D},) scale, got "
                            f"{scale.dtype} {tuple(scale.shape)}")
        if residual is not None and residual.shape != x.shape:
            raise ValueError(f"residual {tuple(residual.shape)} is not x's "
                             f"{tuple(x.shape)}")
        y = torch.empty_like(x)
        x_out = None if residual is None else torch.empty_like(x)
        if not meta:
            status = build().rms_norm_fwd(
                data_ptr(x), data_ptr(residual), data_ptr(x_out),
                data_ptr(y), data_ptr(scale), rows, D, float(eps),
                stream_ptr(x.device))
            check_cuda_status(status, "rms_norm")
            rms_norm.launches += 1
        return y if residual is None else (x_out, y)


rms_norm.launches = 0


# --- RoPE on q and k -------------------------------------------------------------


def rope_qk_cost(B: int, S: int, H: int, K: int, hd: int, pos_elems: int,
                 pos_itemsize: int) -> costs.Cost:
    """One launch: q and k read and written in place, each once; the
    positions and the float32 frequencies read."""
    return costs.Cost(0.0, 4 * B * S * (H + K) * hd
                      + pos_itemsize * pos_elems + 4 * (hd // 2))


def _positions_2d(positions, B: int, S: int):
    """positions (S,), (1, S) or (B, S) integer as a 2-d view; raises
    otherwise."""
    if positions.dim() == 1:
        positions = positions[None]
    if (positions.dtype not in (torch.int32, torch.int64)
            or positions.dim() != 2 or positions.shape[1] != S
            or positions.shape[0] not in (1, B)):
        raise ValueError(f"rope_qk takes integer positions (S,), (1, S) or "
                         f"(B, S) for B={B}, S={S}, got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    return positions


def rope_qk(q, k, positions, freqs):
    """q (B,S,H,hd) and k (B,S,K,hd) rotated by ``positions`` (integer,
    (S,), (1,S) or (B,S)) at ``freqs`` (hd/2,), half-split convention;
    returns (q, k), rotated in place on the card."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    tensors = (q, k, positions, freqs)
    with costs.recording("rope_qk", lambda: rope_qk_cost(
            B, S, H, K, hd, positions.numel(), positions.element_size())):
        meta = is_meta(*tensors)
        if not meta and not is_cuda(*tensors):
            return rope_qk_plain(q, k, positions, freqs)
        _check("rope_qk", (q, k), hd // 2 if hd % 2 == 0 else 1, (freqs,))
        if k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != hd:
            raise ValueError(f"rope_qk: q {tuple(q.shape)} and k "
                             f"{tuple(k.shape)} differ in (B, S, hd)")
        if freqs.dtype != torch.float32 or tuple(freqs.shape) != (hd // 2,):
            raise TypeError(f"rope_qk takes float32 ({hd // 2},) freqs, got "
                            f"{freqs.dtype} {tuple(freqs.shape)}")
        pos = _positions_2d(positions, B, S)
        if not meta:
            p_sb = pos.stride(0) if pos.shape[0] > 1 else 0
            status = build().rope_qk_fwd(
                data_ptr(q), data_ptr(k), data_ptr(pos),
                int(pos.dtype == torch.int32), data_ptr(freqs), B, S, H, K,
                hd, p_sb, pos.stride(1), stream_ptr(q.device))
            check_cuda_status(status, "rope_qk")
            rope_qk.launches += 1
        return q, k


rope_qk.launches = 0


# --- SwiGLU's silu(gate) * up ----------------------------------------------------


def silu_mul_cost(n: int) -> costs.Cost:
    """One launch: gate and up read, h written, each once."""
    return costs.Cost(0.0, 2 * 3 * n)


def silu_mul(gate, up):
    """``silu(gate) * up`` in gate's dtype, silu's result rounded to it
    first as the eager chain stores it."""
    with costs.recording("silu_mul", lambda: silu_mul_cost(gate.numel())):
        meta = is_meta(gate, up)
        if not meta and not is_cuda(gate, up):
            return silu_mul_plain(gate, up)
        _check("silu_mul", (gate, up), gate.shape[-1])
        if up.shape != gate.shape:
            raise ValueError(f"silu_mul: gate {tuple(gate.shape)} and up "
                             f"{tuple(up.shape)} differ")
        h = torch.empty_like(gate)
        if not meta:
            status = build().silu_mul_fwd(
                data_ptr(gate), data_ptr(up), data_ptr(h), gate.numel(),
                stream_ptr(gate.device))
            check_cuda_status(status, "silu_mul")
            silu_mul.launches += 1
        return h


silu_mul.launches = 0
