"""Training launcher: the port of ``repro/launch/train.py``.

Trains a REDUCED variant of the selected arch on the synthetic pipeline
unless ``--full`` is given; on the card (the default device) the gradients
run through the kernels' backward kernels: K1's for attention, K4's for
rwkv6's WKV recurrence, K5's for zamba2's SSD scan.  ``--device cpu`` runs
the port on the CPU, kernels' plain versions and all.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --steps 200 --seq-len 64 --batch 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --steps 60 --seq-len 32 --batch 8 [--device cpu]

The JAX launcher's ``--multi-pod`` (the production TPU mesh) has no
meaning on one card and is refused.  The data carry tokens and labels
only, as the JAX launcher's do: the dense, moe, ssm and hybrid families
train through it, and the vlm and encdec families (which also take
images or frames) through ``Trainer`` directly.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduce_for_smoke
from repro_torch.models.build import build_model
from repro_torch.training import (DataConfig, OptimizerConfig, SyntheticLM,
                                  Trainer, TrainerConfig)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b",
                    choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the JAX launcher's production TPU mesh; refused "
                         "here (one card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "port on the CPU)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod names a TPU mesh; the port trains on one card")
    return args


def train(args: argparse.Namespace) -> Tuple[Trainer, List[Dict]]:
    """Build the model, data and trainer the flags name and fit; returns
    the trainer (its params, state and checkpoints) and the history."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduce_for_smoke(cfg)
    model = build_model(cfg)

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, num_dialects=1))
    opt = OptimizerConfig(peak_lr=args.lr,
                          warmup_steps=max(args.steps // 10, 5),
                          total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                         ckpt_dir=args.ckpt_dir,
                         grad_accum=args.grad_accum)
    trainer = Trainer(model, opt, tcfg, seed=0, device=args.device)
    return trainer, trainer.fit(iter(data))


def main(argv=None) -> int:
    args = parse_args(argv)
    _, hist = train(args)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(hist, f, indent=1)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[train] {args.arch}: loss {first:.4f} -> {last:.4f} over "
          f"{args.steps} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
