"""GQA attention (full / causal / sliding-window / cross): the port of the
full-sequence half of ``repro/models/attention.py``.

Shapes: x (B, S, D); q (B, S, H, hd); k/v (B, Skv, K, hd); GQA groups
G=H/K.

Full-sequence attention, self and cross (Skv != S), always goes through
``kernels.flash_attention``: on a CUDA tensor that launches the Hopper
kernel (a shape the kernel cannot take raises), on a CPU tensor it runs
the kernel's plain version.  ``gqa_attention`` stays the
materialised-scores reference the tests hold it against.  Cross K/V
projected from float32 frames or image embeddings keep JAX's promotion to
float32 (``layers.matmul``) and are cast to q's dtype where they enter a
kernel, which takes one dtype.

The decode half (``init_kv_cache`` .. ``decode_attn_block``) keeps one
cache per layer as a (B, Smax, K, hd) view of the stacked
(L, B, Smax, K, hd) cache, and writes each tick's K/V into it IN PLACE:
the JAX package donates the state to get the same effect, and a copy of
the cache per tick would move gigabytes at serving sizes.  One-token
attention goes through ``kernels.decode_attention``, against the cache or,
in ``cross_decode_attn_block``, a fixed image or audio K/V.

Under ``kv_cache_f8`` (``repro_torch.opt``, off by default as in the JAX
package) a bfloat16 config's GQA cache is float8_e4m3fn.  Every write into
a cache goes through ``to_cache``, which gives the reference's bytes (NaN,
not saturation, above the e4m3 overflow edge), and moves the bytes through
a uint8 view (``raw``), since not every indexing kernel of torch takes
fp8.  K2 reads the e4m3 cache directly; the plain paths dequantize it to
bf16 first, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import opt
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.decode_attention.ref import raw
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_block import rms_norm_plain
from repro_torch.models.layers import (apply_rope, apply_rope_qk,
                                       compute_dtype, dense_init, matmul)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   kv_input_dim: Optional[int] = None):
    """GQA projection params. ``kv_input_dim`` != None -> cross-attention
    (k/v projected from a different stream)."""
    d, hd = cfg.d_model, cfg.head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads
    dkv = kv_input_dim or d
    dt = compute_dtype(cfg)
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h * hd), dt),
        "wk": dense_init(gen, (dkv, k * hd), dt),
        "wv": dense_init(gen, (dkv, k * hd), dt),
        "wo": dense_init(gen, (h * hd, d), dt),
    }
    if cfg.use_bias:
        p.update(bq=torch.zeros((h * hd,), dtype=dt, device=dev),
                 bk=torch.zeros((k * hd,), dtype=dt, device=dev),
                 bv=torch.zeros((k * hd,), dtype=dt, device=dev),
                 bo=torch.zeros((d,), dtype=dt, device=dev))
    if cfg.use_qk_norm:
        p["qnorm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["knorm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def _linear(x, w, b=None):
    y = matmul(x, w)
    return y if b is None else y + b


def project_qkv(p, x, cfg: ModelConfig, kv_x=None, positions=None,
                rope: bool = True):
    """Project and (optionally) rotate q/k/v. Returns (B,S,H,hd), 2x(B,Skv,K,hd)."""
    B, S, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _linear(x, p["wq"], p.get("bq")).reshape(B, S, h, hd)
    kk = _linear(kv_x, p["wk"], p.get("bk")).reshape(B, Skv, k, hd)
    vv = _linear(kv_x, p["wv"], p.get("bv")).reshape(B, Skv, k, hd)
    if cfg.use_qk_norm:
        q = rms_norm_plain(q, p["qnorm"])
        kk = rms_norm_plain(kk, p["knorm"])
    if rope and cfg.rope_theta > 0:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q, kk = apply_rope_qk(q, kk, positions, cfg.rope_theta)
    return q, kk, vv


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------


def make_mask(S: int, Skv: int, *, causal: bool, window: Optional[int] = None,
              q_offset=0, kv_lengths=None, device=None):
    """(1|B, 1, S, Skv) boolean mask; True = attend."""
    qi = torch.arange(S, device=device)[:, None] + q_offset
    ki = torch.arange(Skv, device=device)[None, :]
    m = torch.ones((S, Skv), dtype=torch.bool, device=device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    m = m[None, None]                                # (1,1,S,Skv)
    if kv_lengths is not None:                       # right-padded rows
        valid = ki[0] < kv_lengths.to(ki.device)[:, None]   # (B,Skv)
        m = m & valid[:, None, None, :]
    return m


# ---------------------------------------------------------------------------
# Core attention (materialised scores)
# ---------------------------------------------------------------------------


def gqa_attention(q, k, v, mask=None, logit_cap: Optional[float] = None):
    """q (B,S,H,hd), k/v (B,Skv,K,hd) -> (B,S,H,hd). fp32 softmax, products
    in fp32 (a bf16 product is exact in fp32); P is cast to v's dtype
    before P.V under ``attn_dtype`` (the JAX package's default) and stays
    fp32 without it."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scale = 1.0 / (hd ** 0.5)
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if opt.enabled("attn_dtype"):
        probs = probs.to(v.dtype).float()
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def attention_block(p, x, cfg: ModelConfig, *, positions=None, kv_x=None,
                    causal: bool = True, window: Optional[int] = None,
                    kv_lengths=None, rope: bool = True):
    """Full-sequence attention (prefill / ensemble forward / cross, where
    ``kv_x`` (B, Skv, Dkv) feeds k/v).  Returns (B,S,D)."""
    q, k, v = project_qkv(p, x, cfg, kv_x=kv_x, positions=positions,
                          rope=rope)
    return attend(p, q, k, v, cfg, causal=causal, window=window,
                  lengths=kv_lengths)


def attend(p, q, k, v, cfg: ModelConfig, *, causal: bool,
           window: Optional[int] = None, lengths=None):
    """Projected q (B,S,H,hd) over k/v (B,Skv,K,hd) through
    ``flash_attention``, then the output projection: (B,S,D).  k/v are
    cast to q's dtype, the one dtype the kernel takes."""
    B, S = q.shape[:2]
    out = flash_attention(q, k.to(q.dtype), v.to(q.dtype), causal=causal,
                          window=window, lengths=lengths)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return _linear(out, p["wo"], p.get("bo"))


# ---------------------------------------------------------------------------
# KV cache ops (decode)
# ---------------------------------------------------------------------------

# The plain one-token attention: the JAX model layer's ``decode_attention_ref``
decode_attention_ref = decode_attention_plain


E4M3 = torch.float8_e4m3fn
# |x| above this rounds past e4m3fn's largest finite value, 448 (464 is the
# midpoint to the next step and rounds to even, 448)
E4M3_EDGE = 464.0


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    """float8_e4m3fn under ``kv_cache_f8`` for a bfloat16 config, else the
    compute dtype (bf16 or fp32)."""
    if opt.enabled("kv_cache_f8") and cfg.dtype == "bfloat16":
        return E4M3
    return compute_dtype(cfg)


def to_cache(x, dtype: torch.dtype):
    """``x`` cast to a cache's dtype.  For e4m3 these are the reference's
    bytes (``jnp.astype(float8_e4m3fn)``): round to nearest even, and NaN
    keeping x's sign for |x| > 464, inf and NaN.  torch's own cast
    saturates there to +-448 (0x7E / 0xFE), one bit short of the NaN
    bytes (0x7F / 0xFF), so that bit is set where |x| > 464: four
    elementwise kernels a call, a few hundred a tick."""
    if dtype != E4M3 or x.dtype == E4M3:
        return x.to(dtype)
    y = x.to(E4M3).view(torch.uint8)
    return (y | (x.abs() > E4M3_EDGE).view(torch.uint8)).view(E4M3)


def store(cache, index, new) -> None:
    """``cache[index] = new`` in the cache's dtype (``to_cache``), IN PLACE,
    moving bytes for an e4m3 cache (``raw``)."""
    raw(cache)[index] = raw(to_cache(new, cache.dtype))


def init_kv_cache(num_layers: int, batch: int, max_len: int,
                  cfg: ModelConfig, dtype=None, device=None):
    dt = dtype or cache_dtype(cfg)
    shape = (num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _write_rows(cache, new, slots):
    """cache[b, slots[b]] = new[b] for every row b, in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    store(cache, (rows, slots), new)


def write_token(cache, new, lengths):
    """cache (B, Smax, ...)[b, lengths[b]] = new[b], IN PLACE.  A row whose
    position is past the cache's end keeps its cache as it was, as JAX
    drops an out-of-range scatter: its write is aimed at the last slot
    with that slot's own contents (masked, not clamped: no value of the
    new token lands anywhere)."""
    Smax = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    inside = (lengths < Smax).reshape((-1,) + (1,) * (new.dim() - 1))
    slots = torch.clamp(lengths, max=Smax - 1).long()
    kept = torch.where(inside, raw(to_cache(new, cache.dtype)),
                       raw(cache)[rows, slots])
    raw(cache)[rows, slots] = kept


def cache_write(cache_k, cache_v, new_k, new_v, lengths):
    """Write one token per row at position lengths[b], IN PLACE
    (``write_token``).  cache_k/v: (B, Smax, K, hd); new_k/v: (B, 1, K,
    hd); lengths: (B,).  Returns (cache_k, cache_v)."""
    write_token(cache_k, new_k[:, 0], lengths)
    write_token(cache_v, new_v[:, 0], lengths)
    return cache_k, cache_v


def ring_write(cache_k, cache_v, new_k, new_v, lengths, window: int):
    """Ring-buffer write, in place: token at position L lands in slot
    L % window, so a ring of size ``window`` holds the last ``window``
    tokens.  Returns (cache_k, cache_v)."""
    slots = (lengths % window).long()
    _write_rows(cache_k, new_k[:, 0], slots)
    _write_rows(cache_v, new_v[:, 0], slots)
    return cache_k, cache_v


def ring_lengths(lengths, window: int):
    """#valid ring slots after the current token was written."""
    return torch.clamp(lengths + 1, max=window)


def ring_fill(k_full, lengths, window: int):
    """Pack the last ``window`` positions of a (B, S, ...) tensor into ring
    order: slot s holds the newest token t < L with t % window == s."""
    B, S = k_full.shape[:2]
    s = torch.arange(window, device=k_full.device)[None, :]
    L = lengths.to(k_full.device).long()[:, None]
    t = L - 1 - torch.remainder(L - 1 - s, window)    # (B, W), may be < 0
    t = torch.clamp(t, 0, S - 1)
    rows = torch.arange(B, device=k_full.device)[:, None]
    return k_full[rows, t]


def fill_cache(cache, new, lengths, ring: bool) -> None:
    """Prefill's cache write, IN PLACE: cache (B, Smax, ...) takes new
    (B, S, ...) in its dtype (``to_cache``), as a ring of the last Smax
    positions (``ring_fill``) or at positions [0, S) with the slots past S
    zeroed."""
    new, dst = raw(to_cache(new, cache.dtype)), raw(cache)
    if ring:
        dst.copy_(ring_fill(new, lengths, cache.shape[1]))
    else:
        dst[:, :new.shape[1]].copy_(new)
        dst[:, new.shape[1]:].zero_()


def decode_attn_block(p, x1, layer_cache_k, layer_cache_v, lengths,
                      cfg: ModelConfig, *, window: Optional[int] = None,
                      rope: bool = True):
    """Single-token self-attention with an in-place cache write.

    If the cache is ring-sized (Smax <= window), writes wrap and the
    window mask is implicit in the ring's lengths.  x1: (B, 1, D).
    Returns (out (B,1,D), cache_k, cache_v)."""
    B = x1.shape[0]
    positions = lengths[:, None]                       # this token's position
    q, k, v = project_qkv(p, x1, cfg, positions=positions, rope=rope)
    Smax = layer_cache_k.shape[1]
    if window is not None and Smax <= window:          # ring mode
        ck, cv = ring_write(layer_cache_k, layer_cache_v, k, v, lengths,
                            Smax)
        out = decode_attention(q[:, 0], ck, cv, ring_lengths(lengths, Smax))
    else:
        ck, cv = cache_write(layer_cache_k, layer_cache_v, k, v, lengths)
        out = decode_attention(q[:, 0], ck, cv, lengths + 1, window=window)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return _linear(out, p["wo"], p.get("bo")), ck, cv


def cross_decode_attn_block(p, x1, kv_k, kv_v, cfg: ModelConfig,
                            kv_lengths=None):
    """Single-token cross-attention against a FIXED K/V (image or audio),
    kv_k/v (B, T, K, hd) filled at prefill; every row attends all T keys
    unless ``kv_lengths`` says otherwise.  x1 (B, 1, D).  Returns
    (B, 1, D)."""
    B = x1.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q = _linear(x1, p["wq"], p.get("bq")).reshape(B, 1, h, hd)
    if cfg.use_qk_norm:
        q = rms_norm_plain(q, p["qnorm"])
    T = kv_k.shape[1]
    lengths = (kv_lengths if kv_lengths is not None else
               torch.full((B,), T, dtype=torch.int32, device=x1.device))
    out = decode_attention(q[:, 0], kv_k, kv_v, lengths)
    out = out.reshape(B, 1, h * hd)
    return _linear(out, p["wo"], p.get("bo"))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    dt = compute_dtype(cfg)
    dev = gen.device
    qh = m.rope_head_dim + m.nope_head_dim
    return {
        "q_a": dense_init(gen, (d, m.q_lora_rank), dt),
        "q_a_scale": torch.ones((m.q_lora_rank,), dtype=torch.float32,
                                device=dev),
        "q_b": dense_init(gen, (m.q_lora_rank, H * qh), dt),
        "kv_a": dense_init(gen, (d, m.kv_lora_rank + m.rope_head_dim), dt),
        "kv_a_scale": torch.ones((m.kv_lora_rank,), dtype=torch.float32,
                                 device=dev),
        "kv_b": dense_init(
            gen, (m.kv_lora_rank, H * (m.nope_head_dim + m.v_head_dim)), dt),
        "wo": dense_init(gen, (H * m.v_head_dim, d), dt),
    }


def _mla_q(p, x, cfg: ModelConfig, positions):
    """q (B,S,H, nope | rope) -> (q_nope, q_rope rotated)."""
    m = cfg.mla
    B, S, _ = x.shape
    q_lat = rms_norm_plain(x @ p["q_a"], p["q_a_scale"])
    q = (q_lat @ p["q_b"]).reshape(B, S, cfg.num_heads,
                                   m.rope_head_dim + m.nope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p, x, cfg: ModelConfig, positions):
    """kv_a = [c_kv (kv_lora_rank) | k_rope] -> (normed c_kv (B,S,kvr),
    rotated k_rope (B,S,rope)), the latent cache's two halves."""
    m = cfg.mla
    c_kv, k_rope = (x @ p["kv_a"]).split(
        [m.kv_lora_rank, m.rope_head_dim], dim=-1)
    c_kv = rms_norm_plain(c_kv, p["kv_a_scale"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    """1/sqrt(nope + rope): q.k spans both halves."""
    return (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim) ** -0.5


def mla_full(p, x, cfg: ModelConfig, *, positions=None, kv_lengths=None):
    """Full-sequence MLA with per-head k, v materialised, scores and P.V
    in fp32.  Returns (out (B,S,D), c_kv, k_rope): the latent halves are
    what prefill writes into the cache."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_ckv(p, x, cfg, positions)
    kvb = (c_kv @ p["kv_b"]).reshape(B, S, H,
                                     m.nope_head_dim + m.v_head_dim)
    k_nope, v = kvb.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    scores = (torch.einsum("bshn,bthn->bhst", q_nope.float(),
                           k_nope.float())
              + torch.einsum("bshr,btr->bhst", q_rope.float(),
                             k_rope.float())) * _mla_scale(cfg)
    mask = make_mask(S, S, causal=True, kv_lengths=kv_lengths,
                     device=x.device)
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhst,bthv->bshv", probs, v.float())
    out = out.reshape(B, S, H * m.v_head_dim).to(x.dtype)
    return out @ p["wo"], c_kv, k_rope


def mla_attention_block(p, x, cfg: ModelConfig, *, positions=None,
                        kv_lengths=None):
    """Full-sequence MLA (forward / prefill). Returns (B,S,D)."""
    return mla_full(p, x, cfg, positions=positions,
                    kv_lengths=kv_lengths)[0]


def init_mla_cache(num_layers: int, batch: int, max_len: int,
                   cfg: ModelConfig, dtype=None, device=None):
    """The latent cache keeps the compute dtype, ``kv_cache_f8`` or not
    (the JAX package's ``init_mla_cache``)."""
    m = cfg.mla
    dt = dtype or compute_dtype(cfg)
    return {
        "ckv": torch.zeros((num_layers, batch, max_len, m.kv_lora_rank),
                           dtype=dt, device=device),
        "krope": torch.zeros((num_layers, batch, max_len, m.rope_head_dim),
                             dtype=dt, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def mla_decode_block(p, x1, c_cache, r_cache, lengths, cfg: ModelConfig):
    """Absorbed-matrix MLA decode: attention in the latent (kv_lora) space.

    x1 (B,1,D); c_cache (B,Smax,kvr); r_cache (B,Smax,rope), written IN
    PLACE at ``lengths``.  W_UK is absorbed into q (fp32); under
    ``attn_dtype`` (the JAX package's default) q_abs and P are cast to the
    cache dtype before their products, which accumulate in fp32; without
    it both stay fp32.  Returns (out (B,1,D), c_cache, r_cache)."""
    m = cfg.mla
    B = x1.shape[0]
    H = cfg.num_heads
    positions = lengths[:, None]
    q_nope, q_rope = _mla_q(p, x1, cfg, positions)       # (B,1,H,n),(B,1,H,r)
    c_kv, k_rope = _mla_ckv(p, x1, cfg, positions)       # (B,1,kvr),(B,1,r)
    write_token(c_cache, c_kv[:, 0], lengths)
    write_token(r_cache, k_rope[:, 0], lengths)
    kvb = p["kv_b"].reshape(m.kv_lora_rank, H,
                            m.nope_head_dim + m.v_head_dim)
    w_uk = kvb[:, :, :m.nope_head_dim]                   # (kvr,H,n)
    w_uv = kvb[:, :, m.nope_head_dim:]                   # (kvr,H,v)
    q_abs = torch.einsum("bhn,chn->bhc", q_nope[:, 0].float(),
                         w_uk.float())                   # (B,H,kvr)
    cdt = c_cache.dtype
    c32 = c_cache.float()
    lowp = opt.enabled("attn_dtype")
    if lowp:
        q_abs = q_abs.to(cdt).float()
    scores = (torch.einsum("bhc,btc->bht", q_abs, c32)
              + torch.einsum("bhr,btr->bht", q_rope[:, 0].float(),
                             r_cache.float())) * _mla_scale(cfg)
    Smax = c_cache.shape[1]
    valid = (torch.arange(Smax, device=x1.device)[None, :]
             < (lengths + 1)[:, None])
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if lowp:
        probs = probs.to(cdt).float()
    out_lat = torch.einsum("bht,btc->bhc", probs, c32)
    out = torch.einsum("bhc,chv->bhv", out_lat, w_uv.float())
    out = out.reshape(B, 1, H * m.v_head_dim).to(x1.dtype)
    return out @ p["wo"], c_cache, r_cache
