"""Paged decode path for the dense transformer: a block-paged KV pool with
page-table indirection, context-aware suffix prefill, and O(1) reattach.

The port of ``repro/models/paged.py``.  The dense decode state is
``(L, B, Smax, K, hd)``: every slot reserves worst-case context.  The
paged state replaces the per-slot axis with a shared PAGE POOL plus a
per-slot page table:

    cache:      {"k": (L, P, ps, K, hd), "v": (L, P, ps, K, hd)}
    page_table: (B, MP) int32  — slot b's logical page j lives in physical
                page ``page_table[b, j]`` (0 = the reserved dump page)
    length:     (B,)   int32  — tokens written so far, same as dense

Token t of slot b lives at ``(page_table[b, t // ps], t % ps)``.  Gathering
a row's pages reconstructs the dense ``(Smax, K, hd)`` cache row
(MP * ps == Smax).  Pages are refcounted host-side
(``repro_torch.core.kv_pager``), which buys shared prefixes and
pin-while-parked preemption.

  * ``init_paged_state``   — the pool and table, on the caller's device.
  * ``paged_decode_step``  — one token: write the new K/V IN PLACE into
    each row's current page (``pool[pg, off] = k``; vacant rows all land
    on the dump page, at duplicate indices whose winner is undefined on
    CUDA — harmless, since nothing valid reads page 0), then attend
    through the page table with ``paged_decode_attention`` (K3 on a CUDA
    tensor, its plain gathered-view version on a CPU one).
  * ``paged_verify_step``  — the speculative verify window: W positions
    written through the table (past the table: the dump page), then one
    ``paged_decode_attention`` call per position.
  * ``paged_prefill``      — context-aware prefill: suffix tokens at
    absolute positions ``ctx_len + i`` attend to [gathered context pages ||
    suffix K/V] under a per-row mask, and the suffix K/V is committed in
    place to freshly allocated pages.  With no context pages (C == 0) this
    is exactly the port's dense prefill computation (K1 through
    ``attention.flash_attention``), which keeps paged and dense streams
    identical for fresh prompts.  With C > 0 the attention is the
    materialised-scores ``gqa_attention``, as in the JAX package.

The pool takes the dense cache's dtype (``attention.cache_dtype``:
float8_e4m3fn under ``kv_cache_f8`` for a bfloat16 config); every write goes
through ``attention.store`` and every gather through ``take`` (bytes),
and the C > 0 prefill reads the context pages dequantized to the K/V's
dtype, as the JAX package does.

As with the dense engine, a state passed into ``paged_prefill`` or
``paged_decode_step`` is written in place and must not be reused except
through the returned one.  The dense and moe families page with GQA
attention (a moe config's first dense layers get a ``cache_dense`` pool
of their own, indexed by the same table); MLA's latent cache and the
recurrent states do not page, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.decode_attention.ref import take
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_norm
from repro_torch.models.transformer import (_residual, layer_views,
                                            project_logits, stacks, subtree)


def supports_paging(cfg: ModelConfig) -> bool:
    """Paged KV covers the self-attention transformer families with a
    standard (k, v) cache; MLA/latent and recurrent states do not page."""
    return cfg.family in ("dense", "moe") and cfg.attn_kind == "gqa"


def init_paged_state(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, max_pages_per_seq: int, dtype=None,
                     device=None) -> Dict[str, Any]:
    if not supports_paging(cfg):
        raise ValueError(f"{cfg.name}: family {cfg.family}/{cfg.attn_kind} "
                         "has no paged KV path")
    dt = dtype or attn.cache_dtype(cfg)
    state: Dict[str, Any] = {}
    for _, key, n, _ in stacks(cfg):
        shape = (n, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
        state[key] = {"k": torch.zeros(shape, dtype=dt, device=device),
                      "v": torch.zeros(shape, dtype=dt, device=device)}
    state["length"] = torch.zeros((num_slots,), dtype=torch.int32,
                                  device=device)
    state["page_table"] = torch.zeros((num_slots, max_pages_per_seq),
                                      dtype=torch.int32, device=device)
    return state


def _layers(params, state, cfg: ModelConfig):
    """(layer params, layer i's k pool, v pool) over every stack, in
    order."""
    for prefix, key, _, _ in stacks(cfg):
        pool_k, pool_v = state[key]["k"], state[key]["v"]
        for i, lp in enumerate(layer_views(params, prefix)):
            yield lp, pool_k[i], pool_v[i]


def _gathered_view(pool_k, pool_v, table):
    """Page-table gather -> the contiguous (B, MP*ps, K, hd) cache view, in
    the pool's dtype."""
    B, MP = table.shape
    _, ps, K, hd = pool_k.shape
    idx = table.long()
    return (take(pool_k, idx).reshape(B, MP * ps, K, hd),
            take(pool_v, idx).reshape(B, MP * ps, K, hd))


def _attn_out(lp, out, cfg: ModelConfig):
    B, S = out.shape[:2]
    return attn._linear(out.reshape(B, S, cfg.num_heads * cfg.head_dim),
                        lp["attn"]["wo"], lp["attn"].get("bo"))


def paged_decode_step(params, token, state, cfg: ModelConfig, *,
                      page_size: int, window: Optional[int] = None):
    """token (B,) -> (logits (B,V), new state).  Appends one position
    through the page table, writing the pool in place; vacant rows (table
    all zeros) write into the dump page and read values nothing
    consumes."""
    window = window if window is not None else cfg.sliding_window
    lengths = state["length"]
    table = state["page_table"]
    B = token.shape[0]
    MP = table.shape[1]
    rows = torch.arange(B, device=table.device)
    # current write target: logical page lengths // ps (clamped so runaway
    # vacant rows stay inside the table; their zero row -> dump page)
    pg = table[rows, torch.clamp(lengths // page_size, max=MP - 1).long()]
    pg = pg.long()
    off = (lengths % page_size).long()
    x = params["embed"][token.long()][:, None, :]            # (B,1,D)
    positions = lengths[:, None]
    for lp, pk, pv in _layers(params, state, cfg):
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = attn.project_qkv(lp["attn"], h, cfg, positions=positions)
        attn.store(pk, (pg, off), k[:, 0])
        attn.store(pv, (pg, off), v[:, 0])
        # K3 on CUDA, its plain gathered-view version on the CPU
        out = paged_decode_attention(q[:, 0], pk, pv, table, lengths + 1,
                                     window=window)
        x = _residual(cfg, lp, x, h, _attn_out(lp, out[:, None], cfg))[0]
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    logits = project_logits(params, h, cfg)[:, 0]
    return logits, {**state, "length": lengths + 1}


def paged_verify_step(params, tokens, state, cfg: ModelConfig, *,
                      page_size: int, window: Optional[int] = None):
    """Speculative verify through the page table: tokens (B, W) ->
    (logits (B, W, V), new state).

    Window position i of row b lands at absolute position
    ``lengths[b] + i``; the K/V of every window position is written into
    the row's pages first (positions past the table — a row at its
    context ceiling mid-window — go to the dump page instead of
    clobbering the row's last valid page), then query i attends through
    the page table with ``lengths + i + 1`` valid keys: one
    ``paged_decode_attention`` call per window position (K3 on CUDA), as
    ``paged_decode_step`` makes.  Rejected positions are rolled back by the
    caller's accepted-length update alone.  ``state["length"]`` passes
    through untouched."""
    window = window if window is not None else cfg.sliding_window
    lengths = state["length"]
    table = state["page_table"]
    B, W = tokens.shape
    MP = table.shape[1]
    rows = torch.arange(B, device=table.device)[:, None]
    positions = lengths[:, None] + torch.arange(W, device=table.device)
    logical = (positions // page_size).long()
    pg = torch.where(logical < MP,
                     table[rows, torch.clamp(logical, max=MP - 1)],
                     torch.zeros_like(table[:, :1])).long()
    off = (positions % page_size).long()
    x = params["embed"][tokens.long()]                       # (B, W, D)
    for lp, pk, pv in _layers(params, state, cfg):
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = attn.project_qkv(lp["attn"], h, cfg, positions=positions)
        attn.store(pk, (pg, off), k)
        attn.store(pv, (pg, off), v)
        out = torch.stack([paged_decode_attention(q[:, j], pk, pv, table,
                                                  lengths + j + 1,
                                                  window=window)
                           for j in range(W)], dim=1)
        x = _residual(cfg, lp, x, h, _attn_out(lp, out, cfg))[0]
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    return project_logits(params, h, cfg), dict(state)


def _suffix_mask(S: int, n_ctx: int, ctx_lens, suf_lens,
                 window: Optional[int]):
    """(B, 1, S, n_ctx + S) mask for context-aware prefill: suffix query i
    sits at absolute position ``ctx_len + i`` and may attend to valid
    context positions plus causally-earlier valid suffix positions."""
    dev = ctx_lens.device
    B = ctx_lens.shape[0]
    ctx_lens = ctx_lens.long()[:, None]
    ar_s = torch.arange(S, device=dev)[None, :]
    ar_c = torch.arange(n_ctx, device=dev)[None, :]
    qpos = ctx_lens + ar_s                                      # (B, S)
    kpos = torch.cat([ar_c.expand(B, n_ctx), ctx_lens + ar_s], dim=1)
    kvalid = torch.cat([ar_c < ctx_lens,
                        ar_s < suf_lens.long()[:, None]], dim=1)
    m = kvalid[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        m &= kpos[:, None, :] > qpos[:, :, None] - window
    return m[:, None]                                          # (B,1,S,Skv)


def paged_prefill(params, tokens, lengths, state, ctx_table, ctx_lens,
                  dest_table, cfg: ModelConfig, *, page_size: int,
                  window: Optional[int] = None):
    """Context-aware prefill of SUFFIX tokens into freshly allocated pages.

    tokens (B, S): the per-row suffix (prompt minus its shared prefix);
    lengths (B,): valid suffix lengths; ctx_table (B, C): shared context
    pages (C == 0 when nothing is shared — then this is exactly the dense
    prefill computation); ctx_lens (B,): context token counts, page-aligned
    by construction; dest_table (B, ceil(S/ps)): destination pages for the
    suffix chunks (0 entries land in the dump page).

    Returns (first-token logits (B, V), new state).  The pool is written in
    place; ``state["length"]`` and ``state["page_table"]`` pass through
    untouched — the scheduler owns those host-side and re-uploads them on
    slot changes."""
    window = window if window is not None else cfg.sliding_window
    B, S = tokens.shape
    C = ctx_table.shape[1]
    nc = dest_table.shape[1]
    pad_s = nc * page_size - S
    lengths = lengths.to(torch.int32)
    x = params["embed"][tokens.long()]
    positions = ctx_lens.long()[:, None] + torch.arange(
        S, device=x.device)[None, :]
    mask = (None if C == 0 else
            _suffix_mask(S, C * page_size, ctx_lens, lengths, window))
    flat = dest_table.reshape(-1).long()
    for lp, pk, pv in _layers(params, state, cfg):
        h = apply_norm(lp["ln1"], x, cfg)
        q, k, v = attn.project_qkv(lp["attn"], h, cfg, positions=positions)
        if C == 0:
            out = attn.flash_attention(q, k, v, causal=True, window=window,
                                       lengths=lengths)
        else:
            ck, cv = _gathered_view(pk, pv, ctx_table)
            out = attn.gqa_attention(q, torch.cat([ck.to(k.dtype), k], 1),
                                     torch.cat([cv.to(v.dtype), v], 1), mask)
        attn_out = _attn_out(lp, out, cfg)
        # commit the suffix K/V: chunk c -> physical page dest[b, c]
        # (dump-page duplicates across rows/padding are harmless)
        for pool, new in ((pk, k), (pv, v)):
            padded = F.pad(new, (0, 0, 0, 0, 0, pad_s))
            attn.store(pool, flat, padded.reshape(B * nc, page_size,
                                                  *new.shape[2:]))
        x = _residual(cfg, lp, x, h, attn_out)[0]
    h = apply_norm(subtree(params, "final_norm"), x, cfg)
    rows = torch.arange(B, device=h.device)
    logits = project_logits(params, h[rows, lengths.long() - 1], cfg)
    return logits, dict(state)
