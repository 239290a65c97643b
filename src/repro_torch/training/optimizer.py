"""AdamW + LR schedules over the port's flat params: the port of
``repro/training/optimizer.py``.

Params, gradients and moments are flat dicts keyed by the ``/``-joined
param paths (``repro_torch.params``).  The update math runs in float32 and
each result is cast back to its leaf's dtype, as in the JAX package.  JAX
updates functionally and its train step donates the old buffers; here
``update`` writes the new params and moments into the old tensors, one
leaf at a time, so a step never holds a second copy of the params and
the moments (1.83 B params with float32 moments are 22 GB).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"          # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Optional[str] = None   # 'bfloat16' = DeepSeek-V3 recipe


class OptState(NamedTuple):
    step: torch.Tensor                   # int32 scalar
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def lr_at(step, cfg: OptimizerConfig) -> torch.Tensor:
    """The learning rate at ``step`` (a number or a tensor), float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(frac)
    return cfg.peak_lr * warm * decay


def init(params: Dict[str, torch.Tensor],
         moment_dtype: Optional[str] = None) -> OptState:
    dt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    device = next(iter(params.values())).device
    zeros = lambda: {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                     for k, p in params.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=zeros(), nu=zeros())


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; leaves summed
    in sorted key order (the JAX dict tree's leaf order)."""
    total = None
    for k in sorted(tree):
        sq = torch.sum(torch.square(tree[k].to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _decayable(key: str) -> bool:
    """No weight decay on norms/biases/1D params (standard practice).  The
    name is the key's last component, the last dict key of the JAX path."""
    name = key.rsplit("/", 1)[-1]
    return not any(s in name for s in ("scale", "bias", "nbias", "norm",
                                       "mu", "w0", "first", "a_log",
                                       "dt_bias", "d_skip", "gate"))


@torch.no_grad()
def update(grads: Dict[str, torch.Tensor], state: OptState,
           params: Dict[str, torch.Tensor], cfg: OptimizerConfig
           ) -> Tuple[Dict[str, torch.Tensor], OptState, Dict[str, Any]]:
    """One AdamW step, IN PLACE: returns (params, new_state, metrics),
    where params and the state's moments are the given tensors,
    overwritten, and the step is a new tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(step, cfg)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    for key in params:
        p, m, n = params[key], state.mu[key], state.nu[key]
        g = grads[key].to(torch.float32) * scale
        m2 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        n2 = cfg.b2 * n.to(torch.float32) + (1 - cfg.b2) * torch.square(g)
        del g
        upd = (m2 / bc1) / (torch.sqrt(n2 / bc2) + cfg.eps)
        if _decayable(key):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * upd)
        m.copy_(m2)
        n.copy_(n2)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, OptState(step=step, mu=state.mu, nu=state.nu), metrics
