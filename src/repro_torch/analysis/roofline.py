"""Three-term roofline from the port's dry-run records, for one NVIDIA
H100 (the port of ``repro/analysis/roofline.py``).

    compute term    = flops / PEAK_FLOPS (bf16 tensor cores)
    memory term     = bytes / HBM_BW
    collective term = collective bytes / LINK_BW

One card has no link: the port's records hold no collective bytes, so the
term is 0 (``LINK_BW`` is None, and a record with collective bytes is
refused).  The flops and bytes are what ``analysis.costs.Counter`` counted
over the dry-run's step (``launch/dryrun.py``), on one card.

``model_flops`` is the useful-work yardstick, 6 N D (training) or 2 N D
(a forward) with N the active params and D the tokens, as in the JAX
package.  ``kernel_bound`` and ``tc_bound`` give the least time one kernel
launch could take from its ``Cost`` (``kernels/*/ops.py``): every bound
that ``chip_smoke.py`` prints comes from them.

The constants are NVIDIA's data-sheet peaks of the H100 SXM part (dense,
no sparsity), at the full 700 W power limit of the card the port is
measured on (``CARD``, as nvidia-smi names it); a card set below it runs
slower.  ``HBM_BYTES`` is that card's memory as
``torch.cuda.get_device_properties(0).total_memory`` reports it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.configs import SHAPES, InputShape, get_config, get_shape

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12          # bf16 FLOP/s, tensor cores
PEAK_TF32 = 495e12           # TF32 FLOP/s, tensor cores
PEAK_FP32 = 67e12            # fp32 FLOP/s, CUDA cores
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 85_017_493_504   # bytes of device memory (79.18 GiB)
LINK_BW = None               # bytes/s: one card has no link


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    step: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_chip: float
    hlo_flops_per_chip: float
    useful_ratio: float
    fits_hbm: Optional[bool]
    bytes_per_chip: Optional[int]
    raw: Dict[str, Any]

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict[str, Any]:
        d = self.__dict__.copy()
        d.pop("raw")
        return d


def _peak(dtype: str) -> float:
    return {"bfloat16": PEAK_FLOPS, "tf32": PEAK_TF32,
            "float32": PEAK_FP32}[dtype]


def kernel_bound(nbytes: float, flops: float,
                 dtype: str) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM_BW
    and the operations over the peak of ``dtype`` ("bfloat16" on tensor
    cores, "tf32", or "float32" on the CUDA cores)."""
    t_bytes = nbytes / HBM_BW
    t_ops = flops / _peak(dtype)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tc_bound(nbytes: float, products: float,
             other: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations") of a kernel whose products run on
    TF32 tensor cores as a three-term split (three products each: a third
    of the TF32 peak) and the rest on the CUDA cores, against the bytes."""
    t_bytes = nbytes / HBM_BW
    t_ops = products / (PEAK_TF32 / 3) + other / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def model_flops(arch: str, shape: Union[str, InputShape]) -> float:
    """Useful FLOPs for one step of this (arch, shape), whole program."""
    cfg = get_config(arch)
    if isinstance(shape, str):
        shape = get_shape(shape)
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one token per row
    return 2.0 * n_active * shape.global_batch


def _record_shape(record: Dict[str, Any]) -> Union[str, InputShape]:
    """The record's shape: a name of the configs' table, or the
    ``input_shape`` a dry-run of another shape wrote beside it."""
    name = record["shape"]
    if name in SHAPES or "input_shape" not in record:
        return name
    return InputShape(name=name, **record["input_shape"])


def analyze(record: Dict[str, Any]) -> Optional[RooflineRow]:
    if record.get("status") != "ok":
        return None
    n_dev = record["n_devices"]
    flops_chip = float(record["cost"]["flops"] or 0.0)
    bytes_chip = float(record["cost"]["bytes_accessed"] or 0.0)
    coll_chip = float(record["collectives"]["total_bytes"] or 0.0)
    if coll_chip and LINK_BW is None:
        raise ValueError(f"{record['arch']} x {record['shape']}: "
                         f"{coll_chip:.0f} collective bytes, and one card "
                         f"has no link")

    compute_s = flops_chip / PEAK_FLOPS
    memory_s = bytes_chip / HBM_BW
    collective_s = coll_chip / LINK_BW if coll_chip else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    mf_chip = model_flops(record["arch"], _record_shape(record)) / n_dev
    useful = mf_chip / flops_chip if flops_chip else 0.0

    mem = record.get("memory", {})
    per_chip = None
    fits = None
    if mem.get("argument_bytes") is not None:
        per_chip = (mem["argument_bytes"] + (mem.get("temp_bytes") or 0)
                    + (mem.get("output_bytes") or 0)
                    - (mem.get("alias_bytes") or 0))
        fits = per_chip <= HBM_BYTES

    return RooflineRow(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        step=record.get("step", "?"),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops_per_chip=mf_chip,
        hlo_flops_per_chip=flops_chip, useful_ratio=useful,
        fits_hbm=fits, bytes_per_chip=per_chip, raw=record)


def load_results(dir_path: str) -> List[Dict[str, Any]]:
    out = []
    for name in sorted(os.listdir(dir_path)):
        if name.endswith(".json"):
            with open(os.path.join(dir_path, name)) as f:
                out.append(json.load(f))
    return out


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:8.2f}s "
    if x >= 1e-3:
        return f"{x * 1e3:8.2f}ms"
    return f"{x * 1e6:8.1f}us"


def table(rows: List[RooflineRow], mesh: Optional[str] = None) -> str:
    hdr = (f"{'arch':26s} {'shape':12s} {'step':12s} "
           f"{'compute':10s} {'memory':10s} {'collect':10s} "
           f"{'dominant':10s} {'useful':7s} {'GiB/chip':9s} fits")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if mesh and r.mesh != mesh:
            continue
        gib = (f"{r.bytes_per_chip / 2**30:8.2f}" if r.bytes_per_chip
               else "       ?")
        lines.append(
            f"{r.arch:26s} {r.shape:12s} {r.step:12s} "
            f"{_fmt_s(r.compute_s)} {_fmt_s(r.memory_s)} "
            f"{_fmt_s(r.collective_s)} {r.dominant:10s} "
            f"{r.useful_ratio:6.1%} {gib} "
            f"{'Y' if r.fits_hbm else 'N' if r.fits_hbm is not None else '?'}")
    return "\n".join(lines)


def what_would_help(row: RooflineRow) -> str:
    """One sentence: the lever on the dominant term."""
    if row.dominant == "compute":
        if row.useful_ratio < 0.5:
            return ("compute-bound with low useful ratio: cut remat "
                    "recompute / MoE capacity slack before touching layout")
        return "compute-bound near-useful: increase arithmetic intensity "\
               "(fusion, larger tiles) or add cards"
    if row.dominant == "memory":
        return ("memory-bound: shrink bytes touched — windowed/ring KV "
                "cache, bf16 states, fused kernels that keep tiles in "
                "shared memory and registers between ops")
    return ("collective-bound: reshard to cut cross-card traffic — e.g. "
            "batch-only sharding for small tensors, expert-parallel "
            "all-to-all instead of weight all-gather, overlap collectives")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Roofline table of dry-run records (one H100).")
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = [r for r in (analyze(rec) for rec in load_results(args.dir))
            if r is not None]
    print(table(rows, mesh=args.mesh))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([r.as_dict() for r in rows], f, indent=1)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
