"""One-card dry-run: what fits one H100, as a meta-device pass (the port
of ``repro/launch/dryrun.py``).

Per (arch x input shape) the dry-run:
  1. builds the step -- train, prefill or decode, as the JAX package's
     ``build_step`` does, with its long-context policy (``LONG_SKIP``,
     ``LONG_WINDOW``), remat and the ``opt_bf16_moments`` choice of
     moment dtype -- over params, optimizer state, batch and decode state
     that are all meta tensors (shapes and dtypes, no storage);
  2. runs it once on ``torch.device("meta")`` under
     ``analysis.costs.Counter``: the kernel wrappers check their inputs,
     allocate their outputs and scratch as on the card and launch
     nothing;
  3. records the counted flops and bytes and the memory into
     ``results/dryrun/<arch>.<shape>.gpu1.json``, with the JAX record's
     keys where they mean something on one card: ``mesh`` "gpu1",
     ``n_devices`` 1, ``trace_s`` for ``lower_s``/``compile_s``,
     ``collectives.total_bytes`` 0, and ``memory`` defined so that
     roofline's per-chip sum (argument + temp + output - alias) is the
     pass's peak live bytes.  ``alias_bytes`` is the state the step
     updates in place and returns (params and moments in training, the
     cache in prefill and decode), as JAX donates it.

A planning pass, not an entry point onto the device: it allocates
nothing, so it runs and prints the same numbers with or without a card
(another torch version may decompose an op otherwise: the last digits).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out results/dryrun] [--jobs 4]
  PYTHONPATH=src python -m repro_torch.analysis.roofline --dir results/dryrun
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch import opt as opt_flags
from repro_torch.analysis import costs
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.models import layers
from repro_torch.models.build import build_model
from repro_torch.training import optimizer
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import make_train_step

MESH = "gpu1"

# long-context policy (the JAX package's): whisper skips long_500k; dense /
# full-attention archs run it through the sliding-window serving variant.
LONG_SKIP = {"whisper-base"}
LONG_WINDOW = {
    "yi-9b": 4096, "command-r-plus-104b": 4096, "mistral-large-123b": 4096,
    "qwen3-moe-235b-a22b": 4096, "llama-3.2-vision-11b": 4096,
    # native/window-free long-context archs:
    "h2o-danube-1.8b": None,      # native SWA already in config
    "rwkv6-1.6b": None, "zamba2-2.7b": None, "deepseek-v3-671b": None,
}


@dataclass
class Step:
    """One step and its meta arguments."""
    fn: Callable[..., Any]
    args: tuple
    meta: Dict[str, Any]
    cfg: ModelConfig
    shape: InputShape


def build_step(arch: str, shape: Union[str, InputShape], *,
               remat: bool = True, grad_accum: int = 1,
               window_override: Optional[int] = "auto",
               max_len: Optional[int] = None) -> Step:
    """The step of ``shape`` (a name of the configs' table, or an
    ``InputShape``) over meta params, optimizer state, batch and state.
    A prefill's or decode's state holds ``max_len`` tokens a row (the
    shape's ``seq_len`` unless given, as the JAX package's)."""
    cfg = get_config(arch)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    model = build_model(cfg)
    window = None
    if window_override == "auto":
        if shape.name == "long_500k":
            window = LONG_WINDOW.get(arch)
    else:
        window = window_override
    max_len = shape.seq_len if max_len is None else max_len

    params = model.like()
    batch = model.input_specs(shape)

    if shape.kind == "train":
        opt_cfg = OptimizerConfig(
            moment_dtype="bfloat16"
            if opt_flags.enabled("opt_bf16_moments") else None)
        step = make_train_step(model, opt_cfg, grad_accum=grad_accum,
                               remat=remat)
        opt_state = optimizer.init(params, opt_cfg.moment_dtype)
        return Step(step, (params, opt_state, batch),
                    {"step": "train_step"}, cfg, shape)

    if shape.kind == "prefill":
        @torch.no_grad()
        def step(params, batch, state):
            return model.prefill(params, batch, state)
        state = model.state_specs(shape.global_batch, max_len)
        return Step(step, (params, batch, state), {"step": "prefill_step"},
                    cfg, shape)

    # decode: ONE token against a cache of max_len
    kw = {} if window is None else {"window": window}

    @torch.no_grad()
    def step(params, token, state):
        return model.decode(params, token, state, **kw)
    state = model.state_specs(shape.global_batch, max_len, window=window)
    return Step(step, (params, batch["token"], state),
                {"step": "serve_step", "window": window}, cfg, shape)


def measure(step: Step) -> Dict[str, Any]:
    """Run ``step`` once under a ``costs.Counter``: its cost, memory and
    kernel calls (each a launch planned, none made), and the seconds the
    pass took.  The step is counted as a new process's first: the tables
    the models keep on a device after a first call (``layers``' rope and
    sinusoidal tables) are made anew, whatever ran before in this
    process."""
    layers.clear_tables()
    inputs = costs.storages(step.args)
    t0 = time.perf_counter()
    with costs.Counter() as c:
        out = step.fn(*step.args)
    trace_s = time.perf_counter() - t0
    outputs = costs.storages(out)
    args = sum(inputs.values())
    output = sum(outputs.values())
    alias = sum(n for key, n in outputs.items() if key in inputs)
    return {
        "trace_s": round(trace_s, 3),
        "memory": {
            "argument_bytes": args,
            "output_bytes": output,
            # what the pass held above its arguments at its peak, less the
            # outputs it made (still held at its end)
            "temp_bytes": c.peak - (output - alias),
            "alias_bytes": alias,
            "peak_bytes": args + c.peak,
        },
        "cost": {"flops": c.flops, "bytes_accessed": c.bytes},
        "collectives": {"total_bytes": 0},
        "kernels": c.kernels,
    }


def _path(out_dir: str, arch: str, shape_name: str) -> str:
    return os.path.join(out_dir, f"{arch}.{shape_name}.{MESH}.json")


def _write(out_dir: Optional[str], result: Dict[str, Any]) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(_path(out_dir, result["arch"], result["shape"]), "w") as f:
            json.dump(result, f, indent=1)


def run_one(arch: str, shape: Union[str, InputShape], *,
            out_dir: Optional[str] = None, remat: bool = True,
            grad_accum: int = 1, window_override="auto",
            max_len: Optional[int] = None,
            verbose: bool = True) -> Dict[str, Any]:
    shape = get_shape(shape) if isinstance(shape, str) else shape
    if shape.name == "long_500k" and arch in LONG_SKIP:
        result = {"arch": arch, "shape": shape.name, "mesh": MESH,
                  "status": "skipped",
                  "reason": "enc-dec full attention (the JAX package's "
                            "long-context policy)"}
        _write(out_dir, result)
        if verbose:
            print(f"[dryrun] {arch} x {shape.name} x {MESH}: SKIPPED "
                  f"({result['reason']})")
        return result
    step = build_step(arch, shape, remat=remat, grad_accum=grad_accum,
                      window_override=window_override, max_len=max_len)
    m = measure(step)
    cfg = step.cfg
    result = {
        "arch": arch, "shape": shape.name, "mesh": MESH, "status": "ok",
        **step.meta,
        "opt_flags": opt_flags.all_flags(),
        "grad_accum": grad_accum,
        "n_devices": 1,
        **m,
        "params": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }
    if shape.name not in SHAPES:
        result["input_shape"] = {"seq_len": shape.seq_len,
                                 "global_batch": shape.global_batch,
                                 "kind": shape.kind}
    if max_len is not None:
        result["max_len"] = max_len
    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {MESH}: OK "
              f"flops={m['cost']['flops']:.3e} "
              f"bytes={m['cost']['bytes_accessed']:.3e} "
              f"peak={m['memory']['peak_bytes'] / 2 ** 30:.2f} GiB "
              f"(trace {m['trace_s']:.1f}s)", flush=True)
    _write(out_dir, result)
    return result


def _sweep_one(job) -> Optional[str]:
    """One combo of the CLI's sweep under its flags: None, or the
    traceback of its failure."""
    arch, shape, out_dir, remat, grad_accum, opts = job
    try:
        with opt_flags.flags(**opt_flags.parse(opts)):
            run_one(arch, shape, out_dir=out_dir, remat=remat,
                    grad_accum=grad_accum)
        return None
    except Exception:
        return traceback.format_exc()


def _one_thread() -> None:
    torch.set_num_threads(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Meta-device dry-run of every (arch x shape) on one "
                    "card: memory, flops and bytes of one step.")
    ap.add_argument("--arch", choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the JAX dry-run's 512-chip TPU mesh; refused here "
                         "(one card)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the JAX dry-run's two TPU meshes; refused here "
                         "(one card)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--opts", default="none",
                    help="'none' (paper-faithful baseline), 'all', or a "
                         "comma-list of repro_torch.opt flags")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the combos (each pass runs "
                         "on one CPU core)")
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        ap.error("--multi-pod and --both-meshes name TPU meshes; the port's "
                 "dry-run plans one card")
    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    combos = [(a, s) for a in archs for s in shapes]

    # each combo under the flags, which hold for it only (not for the
    # caller's thread after)
    jobs = [(a, s, args.out, not args.no_remat, args.grad_accum, args.opts)
            for a, s in combos]
    if args.jobs > 1:
        # the train steps, the longest passes, first
        jobs.sort(key=lambda j: get_shape(j[1]).kind != "train")
        with multiprocessing.get_context("spawn").Pool(
                args.jobs, initializer=_one_thread) as pool:
            errors = list(pool.imap(_sweep_one, jobs))
    else:
        errors = [_sweep_one(j) for j in jobs]
    failures = 0
    for (a, s, *_), err in zip(jobs, errors):
        if err is not None:
            failures += 1
            print(f"[dryrun] {a} x {s} x {MESH}: FAILED\n{err}")
    print(f"[dryrun] done: {len(combos) - failures}/{len(combos)} OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
