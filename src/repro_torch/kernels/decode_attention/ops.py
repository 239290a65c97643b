"""Flash-decode wrappers in model layout.

``decode_attention`` (K2): q (B,H,hd) against one layer of the dense KV
cache, k/v (B,Smax,K,hd).  ``paged_decode_attention`` (K3): q against one
layer of the page pool, k/v_pages (P,ps,K,hd), through a (B,MP) page
table.

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch the
Hopper kernels in ``csrc/decode_attention.cu`` or raise.  The kernels read
the cache and the pool through their strides, so a layer view of the
stacked (L,B,Smax,K,hd) cache or (L,P,ps,K,hd) pool costs no copy (the TPU
wrappers moved the head axis, and K2's padded Smax, a copy of the whole
layer or pool on every call).  The cache takes q's dtype (float32 or
bfloat16) or, with a bfloat16 q, float8_e4m3fn (the fp8 KV cache), which
both kernels read directly.

Meta tensors (the dry-run) are checked and given the CUDA path's output
and split scratch, planned for H100_SMS multiprocessors, and nothing is
launched.  ``decode_attention_cost`` and ``paged_decode_attention_cost``
give a launch's flops and bytes; each call reports them to an active
``analysis.costs.Counter``."""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.analysis import costs
from repro_torch.kernels.common import (cdiv, check_cuda_status, data_ptr,
                                        is_cuda, is_meta, load_library,
                                        refuse_grad, round_up, stream_ptr)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_plain, paged_decode_attention_plain)

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_HEAD_DIM = 256
MAX_SPLITS = 1024
MIN_KEYS_PER_SPLIT = 64
# K3 stages a split's page-table entries in shared memory (kMaxSplitPages
# in the source)
MAX_SPLIT_PAGES = 8192
# split target: the blocks one wave holds.  The CUDA-core split kernel is
# compiled for three resident 128-thread blocks per SM (kBlocksPerSM in the
# source), the tensor-core one for two (kTcBlocksPerSM: its registers and
# its 104 KB of cp.async ring at head_dim 128).
BLOCKS_PER_SM = 3
TC_BLOCKS_PER_SM = 2
# The tensor-core split kernel (decode_split_mma_kernel) takes a bf16 q and a
# bf16 or e4m3 cache at these head dims with 16-byte aligned rows and serves
# a whole GQA group of up to TC_HEADS query heads in one block (the rows of
# one m16 A tile).
TC_HEAD_DIMS = (32, 64, 80, 96, 128)
TC_HEADS = 16
# the C entries' dtype codes (q's, and the cache's)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
# the cache dtypes each q dtype takes
_CACHE_DTYPES = {torch.float32: (torch.float32,),
                 torch.bfloat16: (torch.bfloat16, torch.float8_e4m3fn)}
_sm_count: Dict[int, int] = {}
# the split plan of a meta launch: the multiprocessors of the card the
# port is measured on, "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi)
H100_SMS = 132


def decode_attention_cost(B: int, H: int, K: int, hd: int, Smax: int,
                          cache_itemsize: int, q_itemsize: int,
                          keys: Optional[int] = None) -> costs.Cost:
    """One K2 launch: the products' flops (q K^T and P V, 4 hd a key a
    head) and the bytes of the valid keys and values read at the cache's
    element size, q read and the output written.  ``keys`` counts the
    valid keys over the batch (each row's min(length, Smax)); by default
    every row is full, which is all a launch's shapes say."""
    keys = B * Smax if keys is None else keys
    return costs.Cost(4 * hd * H * keys,
                      2 * keys * K * hd * cache_itemsize
                      + 2 * B * H * hd * q_itemsize)


def paged_decode_attention_cost(B: int, H: int, K: int, hd: int, MP: int,
                                ps: int, cache_itemsize: int,
                                q_itemsize: int, keys: Optional[int] = None,
                                pages: Optional[int] = None) -> costs.Cost:
    """One K3 launch: K2's cost over the pages' keys and the int32 table
    entries of the ``pages`` a launch reads (by default every row's MP)."""
    keys = B * MP * ps if keys is None else keys
    pages = B * MP if pages is None else pages
    c = decode_attention_cost(B, H, K, hd, MP * ps, cache_itemsize,
                              q_itemsize, keys)
    return costs.Cost(c.flops, c.nbytes + 4 * pages)


def build() -> ctypes.CDLL:
    """Compile (once per process, cached on disk) and bind both kernels."""
    lib = load_library("decode_attention", [SOURCE])
    fn = lib.decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 10
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.paged_decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 10
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _head_dim_pad(hd: int) -> int:
    return next(p for p in (32, 64, 128, 256) if hd <= p)


def heads_per_block(G: int, hd: int, tensor_cores: bool) -> int:
    """Query heads a block serves.  Tensor cores: TC_HEADS, the rows of the
    A tile, so the whole group (G <= 16) is one block.  CUDA cores: the
    group rounded up to a power of two, at most 8 (4 for head_dim above
    128); larger groups take several blocks."""
    if tensor_cores:
        return TC_HEADS
    cap = 8 if hd <= 128 else 4
    return min(cap, 1 << (G - 1).bit_length())


def tensor_core_path(q, k, v) -> bool:
    """Whether a launch takes the tensor-core split kernel: a bf16 q, a
    bf16 or e4m3 cache, a head dim of TC_HEAD_DIMS, G <= TC_HEADS and every
    row start of q and the cache 16-byte aligned, each in its own element
    size (the model's always are).  Everything else takes the CUDA-core
    kernel."""
    hd, G = q.shape[-1], q.shape[1] // k.shape[2]
    return (q.dtype == torch.bfloat16
            and k.dtype in _CACHE_DTYPES[torch.bfloat16]
            and hd in TC_HEAD_DIMS and G <= TC_HEADS
            and all(t.data_ptr() % 16 == 0
                    and all(st * t.element_size() % 16 == 0
                            for st in t.stride()[:-1])
                    for t in (q, k, v)))


def split_plan(B: int, K: int, G: int, Smax: int, hd: int, sms: int,
               tensor_cores: bool) -> tuple:
    """(nsplit, chunk): the KV axis is cut into ``nsplit`` chunks of
    ``chunk`` keys so that the grid fills one wave of the kernel's resident
    blocks per SM without spilling into a second, with at least
    MIN_KEYS_PER_SPLIT keys each.  It depends on shapes only (never on
    ``lengths``, which live on the device)."""
    blocks = B * K * cdiv(G, heads_per_block(G, hd, tensor_cores))
    per_sm = TC_BLOCKS_PER_SM if tensor_cores else BLOCKS_PER_SM
    nsplit = max(1, min(cdiv(Smax, MIN_KEYS_PER_SPLIT),
                        per_sm * sms // blocks, MAX_SPLITS))
    chunk = round_up(cdiv(Smax, nsplit), 16)
    return cdiv(Smax, chunk), chunk


def _sms(device: torch.device) -> int:
    if device.type == "meta":
        return H100_SMS
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


def paged_split_plan(B: int, K: int, G: int, MP: int, ps: int, hd: int,
                     sms: int, tensor_cores: bool) -> tuple:
    """K3's (nsplit, chunk): K2's plan for Smax = MP * ps with ``chunk``
    rounded up to whole pages, so every split starts on a page boundary.
    At ps = 16 (or any ps dividing K2's chunk) it is K2's plan unchanged."""
    Smax = MP * ps
    _, chunk = split_plan(B, K, G, Smax, hd, sms, tensor_cores)
    chunk = round_up(chunk, ps)
    return cdiv(Smax, chunk), chunk


def _check_aligned(hd: int, *tensors) -> None:
    """The kernel reads a lane's span of head dims (its padded head dim /
    32 elements) with vector loads: every row start must be aligned to the
    span, in each tensor's own element size, and hd a multiple of it.  The
    model's q and cache always are."""
    vec = _head_dim_pad(hd) // 32
    if hd % vec:
        raise ValueError(f"decode_attention needs head_dim a multiple of "
                         f"{vec}")
    for t in tensors:
        span = vec * t.element_size()
        if t.data_ptr() % span or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"decode_attention needs {t.dtype} rows "
                             f"aligned to {span} bytes")


def _check_common(name: str, q, k, v, lengths, B: int, K: int,
                  hd: int) -> bool:
    """The checks K2 and K3 share: heads, head_dim, dtypes (a float32 q
    with a float32 cache, or a bfloat16 q with a bfloat16 or e4m3 cache),
    contiguity of the head dimension, lengths, row alignment and the
    grid's size.  Returns whether the launch takes the tensor-core
    kernel."""
    H = q.shape[1]
    if H % K:
        raise ValueError(f"{H} query heads not divisible by {K} kv heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    if (k.dtype != v.dtype
            or k.dtype not in _CACHE_DTYPES.get(q.dtype, ())):
        raise TypeError(f"{name} takes a float32 q and cache, or a bfloat16 "
                        f"q and a bfloat16 or float8_e4m3fn cache, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q and the cache must be "
                         "contiguous")
    if lengths.shape != (B,) or lengths.is_floating_point():
        raise ValueError(f"lengths must be integer ({B},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    _check_aligned(hd, q, k, v)
    G = H // K
    tc = tensor_core_path(q, k, v)
    if B > 65535 or K * cdiv(G, heads_per_block(G, hd, tc)) > 65535:
        raise ValueError(f"grid too large: B={B}, H={H}")
    return tc


def _scratch(q, nsplit: int):
    """Output and the splits' fp32 partials for one launch."""
    B, H, hd = q.shape
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((B, H, nsplit, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    return out, part_acc, part_ml


def decode_attention(q, cache_k, cache_v, lengths, *,
                     window: Optional[int] = None):
    """One-token attention against one cache layer; see
    ``csrc/decode_attention.cu``.  ``lengths`` (B,) counts each row's valid
    keys including this tick's; ``window`` keeps keys with
    ``kpos > length - 1 - window``.  Returns (B,H,hd) in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    def cost():
        B, H, hd = q.shape
        return decode_attention_cost(B, H, cache_k.shape[2], hd,
                                     cache_k.shape[1], cache_k.element_size(),
                                     q.element_size())
    with costs.recording("decode_attention", cost):
        if (not is_meta(q, cache_k, cache_v, lengths)
                and not is_cuda(q, cache_k, cache_v, lengths)):
            return decode_attention_plain(q, cache_k, cache_v, lengths,
                                          window=window)
        return _decode(q, cache_k, cache_v, lengths, window)


def _decode(q, cache_k, cache_v, lengths, window):
    """One K2 launch on CUDA (or meta) inputs."""
    refuse_grad("decode_attention", q, cache_k, cache_v)
    if q.dim() != 3 or cache_k.dim() != 4:
        raise ValueError("decode_attention takes q (B,H,hd) and cache "
                         "k/v (B,Smax,K,hd)")
    B, H, hd = q.shape
    Smax, K = cache_k.shape[1], cache_k.shape[2]
    if cache_k.shape != (B, Smax, K, hd) or cache_v.shape != cache_k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, cache_k "
                         f"{tuple(cache_k.shape)}, cache_v "
                         f"{tuple(cache_v.shape)}")
    tc = _check_common("decode_attention", q, cache_k, cache_v, lengths, B,
                       K, hd)
    G = H // K
    gb = heads_per_block(G, hd, tc)
    nsplit, chunk = split_plan(B, K, G, Smax, hd, _sms(q.device), tc)
    lengths = lengths.to(torch.int32).contiguous()
    out, part_acc, part_ml = _scratch(q, nsplit)
    if q.is_meta:
        return out
    lib = build()
    status = lib.decode_attention_fwd(
        data_ptr(q), data_ptr(cache_k), data_ptr(cache_v), data_ptr(out),
        data_ptr(lengths), data_ptr(part_acc), data_ptr(part_ml),
        _DTYPES[q.dtype], _DTYPES[cache_k.dtype], B, Smax, H, K, hd,
        *q.stride()[:2],
        *cache_k.stride()[:3], *cache_v.stride()[:3], *out.stride()[:2],
        nsplit, chunk, gb, int(window or 0), 1.0 / (hd ** 0.5),
        stream_ptr(q.device))
    check_cuda_status(status, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           window: Optional[int] = None):
    """One-token attention through a page table (K3); see
    ``csrc/decode_attention.cu``.  q (B,H,hd); k/v_pages (P,ps,K,hd), the
    pool in cache layout (a layer view of the stacked pool is read through
    its strides); page_table (B,MP) int32, row b's logical page j living in
    pool page ``page_table[b, j]`` (0 = the dump page); lengths (B,) valid
    keys per row, counting this tick's.  Returns (B,H,hd) in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    tensors = (q, k_pages, v_pages, page_table, lengths)

    def cost():
        B, H, hd = q.shape
        return paged_decode_attention_cost(
            B, H, k_pages.shape[2], hd, page_table.shape[1],
            k_pages.shape[1], k_pages.element_size(), q.element_size())
    with costs.recording("paged_decode_attention", cost):
        if not is_meta(*tensors) and not is_cuda(*tensors):
            return paged_decode_attention_plain(q, k_pages, v_pages,
                                                page_table, lengths,
                                                window=window)
        return _paged_decode(q, k_pages, v_pages, page_table, lengths,
                             window)


def _paged_decode(q, k_pages, v_pages, page_table, lengths, window):
    """One K3 launch on CUDA (or meta) inputs."""
    refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    if q.dim() != 3 or k_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError("paged_decode_attention takes q (B,H,hd), "
                         "k/v_pages (P,ps,K,hd) and page_table (B,MP)")
    B, H, hd = q.shape
    P, ps, K = k_pages.shape[:3]
    MP = page_table.shape[1]
    if (k_pages.shape != (P, ps, K, hd) or v_pages.shape != k_pages.shape
            or page_table.shape[0] != B):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pages "
                         f"{tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}, page_table "
                         f"{tuple(page_table.shape)}")
    if page_table.dtype != torch.int32:
        raise TypeError(f"page_table must be int32, got {page_table.dtype}")
    tc = _check_common("paged_decode_attention", q, k_pages, v_pages,
                       lengths, B, K, hd)
    G = H // K
    gb = heads_per_block(G, hd, tc)
    nsplit, chunk = paged_split_plan(B, K, G, MP, ps, hd, _sms(q.device),
                                     tc)
    if chunk // ps > MAX_SPLIT_PAGES:
        raise ValueError(f"a split of {chunk // ps} pages exceeds the "
                         f"kernel's {MAX_SPLIT_PAGES}")
    lengths = lengths.to(torch.int32).contiguous()
    page_table = page_table.contiguous()
    out, part_acc, part_ml = _scratch(q, nsplit)
    if q.is_meta:
        return out
    lib = build()
    status = lib.paged_decode_attention_fwd(
        data_ptr(q), data_ptr(k_pages), data_ptr(v_pages), data_ptr(out),
        data_ptr(page_table), data_ptr(lengths), data_ptr(part_acc),
        data_ptr(part_ml), _DTYPES[q.dtype], _DTYPES[k_pages.dtype], B, MP,
        ps, H, K, hd,
        *q.stride()[:2], *k_pages.stride()[:3], *v_pages.stride()[:3],
        *out.stride()[:2], nsplit, chunk, gb, int(window or 0),
        1.0 / (hd ** 0.5), stream_ptr(q.device))
    check_cuda_status(status, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
