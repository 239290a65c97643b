"""Times K5's backward kernels against variants of their own source on one
card, in turns, to back the design choices of ``mamba2_ssd_bwd.cu``.
Needs a CUDA card (Hopper) and nvcc.

Each variant is the committed ``mamba2_ssd_bwd.cu`` with text replaced
(every replaced text must occur as often as listed), built beside it from
a scratch directory with ``ssd_mma.cuh``:
  * ``unroll_1``: the k loop of the chunk kernel's products not unrolled
    (the committed kernel unrolls it by two);
  * ``scan_unroll_2``: the boundary scans' k loop unrolled by two (the
    committed scans do not unroll it);
  * ``stage_unroll_4``: the chunk kernel's cp.async staging loops
    unrolled by four, as the scans' are (the committed ones are not);
  * ``group_4`` / ``group_16``: 4 or 16 heads per chunk-kernel block in
    place of 8 (the wrapper's ``HEAD_GROUP`` follows for the variant's
    calls).
For the committed kernels and each variant the script prints ptxas's
registers and spills per kernel, holds the variant to ``ssd_bwd_plain``
at an unaligned T with a nonzero h0 and dhT and at zamba2's training
shape (each gradient within 1e-4 of its largest entry), and times both at
the training shape (B=4, T=2048, H=80, P=N=64; zero h0, no dhT, as
training calls it): CUDA events over 10 calls, committed and variant in
turns (committed, variant, variant, committed), and the device time by
kernel from torch.profiler.  Prints one JSON object per variant.

    python3 scripts/k5_bwd_variants.py [--variants a,b] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "mamba2_ssd" / "csrc"

# name -> ([(old, new, count)], head group): each old text occurs `count`
# times in the source
VARIANTS = {
    "unroll_1": ([("#pragma unroll 2\n  for (int ks = ks0;",
                   "#pragma unroll 1\n  for (int ks = ks0;", 1)], 8),
    "stage_unroll_4": ([("constexpr bool kStageUnroll4 = false;",
                         "constexpr bool kStageUnroll4 = true;", 1)], 8),
    "scan_unroll_2": ([("#pragma unroll 1\n  for (int ks = ks0;",
                        "#pragma unroll 2\n  for (int ks = ks0;", 1)], 8),
    "group_4": ([("constexpr int kGroup = 8;", "constexpr int kGroup = 4;",
                  1)], 4),
    "group_16": ([("constexpr int kGroup = 8;", "constexpr int kGroup = 16;",
                   1)], 16),
}
NAMES = ("x", "dt", "A", "Bm", "Cm", "h0")


def variant_source(name: str, workdir: Path) -> Path:
    """The variant's source under ``workdir/name`` beside a copy of the
    shared header."""
    text = (CSRC / "mamba2_ssd_bwd.cu").read_text()
    for old, new, count in VARIANTS[name][0]:
        if text.count(old) != count:
            raise SystemExit(f"k5_bwd_variants: {old!r} occurs "
                             f"{text.count(old)} times, not {count}")
        text = text.replace(old, new)
    out = workdir / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_mma.cuh").write_text((CSRC / "ssd_mma.cuh").read_text())
    path = out / "mamba2_ssd_bwd.cu"
    path.write_text(text)
    return path


def ptxas_report(ptxas: str) -> dict:
    """Registers and spill bytes per kernel from a ``ptxas -v`` report."""
    out, kernel = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"(ssd_bwd_(?:scan|chunk)_kernel)", line)
        if "Compiling entry" in line and m:
            kernel = m.group(1)
        elif kernel and "spill" in line:
            out.setdefault(kernel, {})["spill_bytes"] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "registers" in line:
            out.setdefault(kernel, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def inputs(B, T, H, P, N, *, seed=0, h0_scale=0.3, dhT=True):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return [rnd(B, T, H, P), torch.nn.functional.softplus(rnd(B, T, H)),
            -torch.exp(rnd(H)), rnd(B, T, N), rnd(B, T, N),
            rnd(B, H, P, N) * h0_scale, rnd(B, T, H, P),
            rnd(B, H, P, N) if dhT else None]


def rel_errors(got, want) -> dict:
    out = {}
    for name, g, w in zip(NAMES, got, want):
        scale = float(w.abs().max())
        out[name] = float((g - w).abs().max()) / (scale if scale else 1.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--workdir", default=None,
                    help="scratch directory for the variants' sources "
                         "(default: a new temporary one)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k5_bwd_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.mamba2_ssd import ops as so
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="k5-variants-"))
    real = so.build_bwd()
    real_group = so.HEAD_GROUP
    card = cs.nvidia_smi_line()
    print(json.dumps({"variant": "committed", "card": card,
                      "ptxas": ptxas_report(
                          str(common.build_log["mamba2_ssd_bwd"]["ptxas"]))}),
          flush=True)
    small = inputs(2, 130, 80, 64, 64, seed=1)
    train = inputs(4, 2048, 80, 64, 64, h0_scale=0.0, dhT=False)
    want_small = so.ssd_bwd_plain(*small)
    want_train = so.ssd_bwd_plain(*train)
    for name in filter(None, args.variants.split(",")):
        path = variant_source(name, workdir)
        lib = common.load_library(f"mamba2_ssd_bwd_{name}", [path],
                                  [path.parent / "ssd_mma.cuh"])
        lib.ssd_bwd.argtypes = real.ssd_bwd.argtypes
        lib.ssd_bwd.restype = real.ssd_bwd.restype
        rec = {"variant": name, "card": card, "ptxas": ptxas_report(str(
            common.build_log[f"mamba2_ssd_bwd_{name}"]["ptxas"]))}

        def use(which):
            so.build_bwd = (lambda: real) if which == "committed" else (
                lambda: lib)
            so.HEAD_GROUP = (real_group if which == "committed"
                             else VARIANTS[name][1])
        try:
            use(name)
            rec["rel_err"] = {
                "T=130 nonzero h0, dhT": rel_errors(so.ssd_bwd(*small),
                                                    want_small),
                "training shape": rel_errors(so.ssd_bwd(*train),
                                             want_train)}
            times = {}
            for which in ("committed", name, name + " again",
                          "committed again"):
                use(which.split()[0])
                times[which] = cs.cuda_time_ms(lambda: so.ssd_bwd(*train),
                                               iters=10, warmup=2)
            for which in ("committed", name):
                use(which)
                rec[f"{which}_device_ms"] = cs.profiled_groups_ms(
                    lambda: so.ssd_bwd(*train),
                    {k: (k,) for k in so.BWD_KERNEL_NAMES}, iters=10)
            rec["event_ms"] = times
        finally:
            use("committed")
        rec["ok"] = all(v <= 1e-4 for errs in rec["rel_err"].values()
                        for v in errs.values())
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
