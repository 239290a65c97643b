"""Mixture-of-Experts layer with capacity-based sort dispatch: the port of
``repro/models/moe.py``.

Top-k routing -> position-within-expert via a stable sort -> scatter into
per-expert capacity buffers (E, C, D) -> one batched product per expert
weight -> gather back.  This is the GShard/Switch dropping formulation:
the expert compute is O(E*C*D*F), the actual expert FLOPs times the
capacity slack.  The JAX package computes all of it in plain jnp, outside
any Pallas kernel, and so does the port (``torch.bmm`` for the expert
products).

Parity with the JAX function is exact in the routing, not only close:
  * ties in the top-k go to the lower expert index, as ``jax.lax.top_k``
    returns them (a stable descending sort, then the first k);
  * positions inside an expert follow the flat assignment order (a
    stable ``argsort``), so the same assignments drop;
  * C = T (dropless) for T <= 128 tokens, else the capacity rule of
    ``capacity_for``; T counts every row and position of the flattened
    input, padding included, so a row's output depends on its batchmates
    once assignments drop.

The expert-parallel ``moe_block_ep`` (a TPU-mesh ``shard_map`` all-to-all)
is not ported: it has no meaning on one GPU.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_mlp, compute_dtype, dense_init,
                                       init_mlp)


def init_moe(gen: torch.Generator,
             cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Params for ONE MoE layer (``stack_init`` stacks them per layer):
    an fp32 router, (E, D, F) / (E, F, D) expert weights and, with shared
    experts, their MLP under ``ws_*`` keys."""
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    dt = compute_dtype(cfg)
    p = {
        "router": dense_init(gen, (d, m.num_experts), torch.float32),
        "we_gate": dense_init(gen, (m.num_experts, d, fe), dt, in_axis=-2),
        "we_up": dense_init(gen, (m.num_experts, d, fe), dt, in_axis=-2),
        "we_down": dense_init(gen, (m.num_experts, fe, d), dt, in_axis=-2),
    }
    if m.num_shared_experts:
        shared = init_mlp(gen, cfg, d_ff=fe * m.num_shared_experts)
        p.update({"ws_" + k.split("_", 1)[1]: v for k, v in shared.items()})
    return p


def _positions_in_expert(expert_ids: torch.Tensor,
                         num_experts: int) -> torch.Tensor:
    """pos[i] = rank of flat assignment i within its expert group, in flat
    order (stable sort), as int32."""
    n = expert_ids.shape[0]
    dev = expert_ids.device
    ids = expert_ids.long()
    sort_idx = torch.argsort(ids, stable=True)
    e_sorted = ids[sort_idx]
    group_start = torch.searchsorted(
        e_sorted, torch.arange(num_experts, device=dev), side="left")
    pos_sorted = torch.arange(n, device=dev) - group_start[e_sorted]
    pos = torch.zeros((n,), dtype=torch.int32, device=dev)
    pos[sort_idx] = pos_sorted.to(torch.int32)
    return pos


def capacity_for(num_tokens: int, top_k: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Per-expert slot count.  C = T (dropless) for T <= 128: a token
    routes to an expert at most once, so decode batches route exactly;
    above, ceil(T * k * factor / E) rounded up to a multiple of 8, at
    least 8."""
    if num_tokens <= 128:
        return num_tokens
    c = math.ceil(num_tokens * top_k * capacity_factor / num_experts)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    probs: torch.Tensor      # (T, E) fp32 softmax of the router logits
    top_p: torch.Tensor      # (T, k) fp32 gate weights (renormalised)
    top_i: torch.Tensor      # (T, k) int64 expert ids, best first
    pos: torch.Tensor        # (T*k,) int32 rank within the expert
    keep: torch.Tensor       # (T*k,) bool: pos < capacity
    capacity: int


def route(p, x2: torch.Tensor, cfg: ModelConfig, *,
          capacity_factor: float = 1.25) -> Routing:
    """Router in fp32 on x2 (T, D): softmax, top-k with ties to the lower
    index, optional renormalisation, positions and the capacity cut."""
    m = cfg.moe
    T = x2.shape[0]
    k, E = m.top_k, m.num_experts
    probs = torch.softmax(x2.float() @ p["router"], dim=-1)       # (T, E)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    if m.norm_topk_prob:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    pos = _positions_in_expert(top_i.reshape(T * k), E)
    C = capacity_for(T, k, E, capacity_factor)
    return Routing(probs, top_p, top_i, pos, pos < C, C)


def moe_block(p, x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (y (..., D) in x's dtype, Switch aux loss scalar).

    All leading dims flatten into one token axis of T rows; the capacity
    is static per call (it depends on T only)."""
    m = cfg.moe
    orig_shape = x.shape
    D = orig_shape[-1]
    x2 = x.reshape(-1, D)
    T = x2.shape[0]
    k, E = m.top_k, m.num_experts
    r = route(p, x2, cfg, capacity_factor=capacity_factor)
    C = r.capacity
    flat_e = r.top_i.reshape(T * k)
    slot = torch.where(r.keep, r.pos, C).long()              # dropped -> C

    # dispatch: (e, slot < C) pairs are unique; every drop lands on slot C,
    # which is cut before the products
    token_idx = torch.arange(T, device=x2.device).repeat_interleave(k)
    buf = x2.new_zeros((E, C + 1, D))
    buf[flat_e, slot] = x2[token_idx]
    buf = buf[:, :C]

    # expert compute: one batched product per weight
    h = F.silu(torch.bmm(buf, p["we_gate"])) * torch.bmm(buf, p["we_up"])
    out_buf = torch.bmm(h, p["we_down"])
    out_buf = torch.cat([out_buf, out_buf.new_zeros((E, 1, D))], dim=1)

    # combine: gather back, weight in x's dtype, sum over k in x's dtype
    y_flat = out_buf[flat_e, slot]                           # (T*k, D)
    y_flat = y_flat * (r.top_p.reshape(T * k, 1)
                       * r.keep[:, None]).to(y_flat.dtype)
    y = y_flat.reshape(T, k, D).sum(dim=1)

    if m.num_shared_experts:
        sp = {"w_" + kk.split("_", 1)[1]: vv
              for kk, vv in p.items() if kk.startswith("ws_")}
        y = y + apply_mlp(sp, x2, cfg)

    # load-balance aux loss (Switch): E * sum(mean prob * dispatch share)
    me = r.probs.mean(dim=0)
    counts = torch.zeros((E,), dtype=torch.float32, device=x2.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e,
                                                   dtype=torch.float32))
    aux = E * torch.sum(me * (counts / (T * k)))
    return y.reshape(orig_shape).to(x.dtype), aux
