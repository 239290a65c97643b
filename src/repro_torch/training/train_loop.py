"""Training loop with gradient accumulation and checkpointing: the port of
``repro/training/train_loop.py``.

The JAX package ``jit``s and ``value_and_grad``s the step; here the step
runs eagerly and ``torch.autograd.grad`` takes the gradients of
``Model.loss`` with respect to the flat params (on the card attention's
gradient is K1's backward kernel).  ``grad_accum > 1`` splits the global
batch into microbatches run one after another, their gradients summed in
float32 and averaged, as the JAX scan does.
Checkpoints are the JAX format's (``training/checkpoint.py``), holding
``{"params": ...}`` as the JAX ``Trainer.save`` writes it, so either
package restores the other's.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.build import Model
from repro_torch.training import checkpoint, optimizer
from repro_torch.training.optimizer import OptimizerConfig, OptState

PARAMS = "params/"      # the checkpoint tree's prefix: {"params": {...}}


def _grads(model: Model, params, batch, remat: bool):
    """(loss, metrics, grads) of ``model.loss`` at ``params``; the params
    enter as fresh leaves that share their storage."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, metrics = model.loss(leaves, batch, remat=remat)
    keys = list(leaves)
    got = torch.autograd.grad(loss, [leaves[k] for k in keys],
                              allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(keys, got)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(model: Model, opt_cfg: OptimizerConfig,
                    grad_accum: int = 1, remat: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); the step overwrites the params and moments it is given
    (``optimizer.update``).

    With grad_accum > 1 the global batch is split into microbatches run
    one after another (activation memory / batch trade-off)."""

    def accum_grads(params, batch):
        if grad_accum == 1:
            return _grads(model, params, batch, remat)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        for i in range(grad_accum):
            mb = {k: t.reshape(grad_accum, t.shape[0] // grad_accum,
                               *t.shape[1:])[i] for k, t in batch.items()}
            loss, _, grads = _grads(model, params, mb, remat)
            for k, g in grads.items():
                acc[k] += g.float()
            lsum = lsum + loss
            del grads
        grads = {k: a / grad_accum for k, a in acc.items()}
        loss = lsum / grad_accum
        return loss, {"loss": loss}, grads

    def train_step(params, opt_state: OptState, batch):
        loss, metrics, grads = accum_grads(params, batch)
        params, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0                  # 0 = only final
    ckpt_dir: Optional[str] = None
    grad_accum: int = 1
    remat: bool = True


class Trainer:
    """``fit`` / ``save`` / ``restore`` over a model's flat params on
    ``device`` (CUDA unless given).  Batches are host arrays (numpy), moved
    to the device per step; params and moments are updated in place."""

    def __init__(self, model: Model, opt_cfg: OptimizerConfig,
                 tcfg: TrainerConfig, params=None, seed: int = 0,
                 device=None):
        self.model = model
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.params = params if params is not None else model.init(
            seed, self.device)
        self.opt_state = optimizer.init(self.params, opt_cfg.moment_dtype)
        self._step_fn = make_train_step(
            model, opt_cfg, grad_accum=tcfg.grad_accum, remat=tcfg.remat)
        self.history: List[Dict[str, float]] = []

    def fit(self, data_iter, steps: Optional[int] = None,
            log: Callable[[str], None] = print) -> List[Dict[str, float]]:
        steps = steps or self.tcfg.total_steps
        t0 = time.perf_counter()
        for step in range(1, steps + 1):
            batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in next(data_iter).items()}
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            if step % self.tcfg.log_every == 0 or step == steps:
                row = {k: float(v) for k, v in metrics.items()}
                row["step"] = step
                row["wall_s"] = time.perf_counter() - t0
                self.history.append(row)
                log(f"step {step:5d}  loss {row['loss']:.4f}  "
                    f"lr {row.get('lr', 0):.2e}  "
                    f"gnorm {row.get('grad_norm', 0):.2f}  "
                    f"{row['wall_s']:.1f}s")
            if (self.tcfg.ckpt_every and self.tcfg.ckpt_dir
                    and step % self.tcfg.ckpt_every == 0):
                self.save(step)
        if self.tcfg.ckpt_dir:
            self.save(steps)
        return self.history

    def save(self, step: int) -> str:
        path = os.path.join(self.tcfg.ckpt_dir, f"step_{step}.ckpt")
        return checkpoint.save(
            path, {PARAMS + k: v for k, v in self.params.items()},
            step=step, meta={"arch": self.model.config.name})

    def restore(self, path: str) -> None:
        like = {PARAMS + k: v for k, v in self.params.items()}
        tree, _ = checkpoint.restore(path, like, device=self.device)
        self.params = {k[len(PARAMS):]: v for k, v in tree.items()}
