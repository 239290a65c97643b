"""Times K4's backward kernels against variants of their own source on one
card, in turns, to back the design choices of ``rwkv6_wkv_bwd.cu``.
Needs a CUDA card (Hopper) and nvcc.

Each variant is the committed ``rwkv6_wkv_bwd.cu`` with text replaced
(every replaced text must occur as often as listed), built beside it from
a scratch directory with ``wkv_mma.cuh``:
  * ``blocks_1``: one chunk-kernel block an SM: launch bounds for one,
    and 32 KB more shared memory so that a second does not fit (the
    committed kernel takes two, at 110 KB each);
  * ``sub_16``: sub-chunks of 16 steps in place of 8 (fewer factored
    products, larger exact diagonal blocks);
  * ``sub_none``: no sub-chunk factoring: one "sub-chunk" of all 32
    steps, every pair s < t of A, dr' and dk' exact on CUDA cores, an
    exponential per (t, s, n);
  * ``scan_rows_64``: the boundary scans take all 64 state rows a block
    (8 warps) in place of 32 (4 warps), so that v and dy are read once.
For the committed kernels and each variant the script prints ptxas's
registers and spills per kernel, holds the variant to ``wkv6_bwd_plain``
at an unaligned T with a nonzero s0 and dsT, under strong decay, and at
rwkv6's training shape (each gradient within 1e-4 of its largest entry),
and times both at the training shape (B=4, T=2048, H=32, N=64; zero s0,
no dsT, as training calls it): CUDA events over 10 calls, committed and
variant in turns (committed, variant, variant, committed), and the device
time by kernel from torch.profiler.  Prints one JSON object per variant.

    python3 scripts/k4_bwd_variants.py [--variants a,b] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "rwkv6_wkv" / "csrc"

# name -> [(old, new, count)]: each old text occurs `count` times in the
# source
VARIANTS = {
    "blocks_1": [("constexpr int kChunkBlocks = 2;",
                  "constexpr int kChunkBlocks = 1;", 1),
                 ("  float u[kDim];\n",
                  "  float u[kDim];\n  float one_block_an_sm[8192];\n", 1)],
    "sub_16": [("constexpr int kSub = 8; ", "constexpr int kSub = 16; ", 1)],
    "sub_none": [("constexpr int kSub = 8; ", "constexpr int kSub = 32; ", 1)],
    "scan_rows_64": [("constexpr int kScanRows = 32;",
                      "constexpr int kScanRows = 64;", 1)],
}
NAMES = ("r", "k", "v", "logw", "u", "s0")


def variant_source(name: str, workdir: Path) -> Path:
    """The variant's source under ``workdir/name`` beside a copy of the
    shared header."""
    text = (CSRC / "rwkv6_wkv_bwd.cu").read_text()
    for old, new, count in VARIANTS[name]:
        if text.count(old) != count:
            raise SystemExit(f"k4_bwd_variants: {old!r} occurs "
                             f"{text.count(old)} times, not {count}")
        text = text.replace(old, new)
    out = workdir / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "wkv_mma.cuh").write_text((CSRC / "wkv_mma.cuh").read_text())
    path = out / "rwkv6_wkv_bwd.cu"
    path.write_text(text)
    return path


def ptxas_report(ptxas: str) -> dict:
    """Registers and spill bytes per kernel from a ``ptxas -v`` report."""
    out, kernel = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"(wkv6_bwd_(?:scan|chunk)_kernel)", line)
        if "Compiling entry" in line:
            kernel = m.group(1) if m else None
        elif kernel and "spill" in line:
            out.setdefault(kernel, {})["spill_bytes"] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "registers" in line:
            out.setdefault(kernel, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def inputs(B, T, H, N, *, seed=0, decay_shift=-1.0, s0_scale=0.3,
           dsT=True):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = rnd(B, T, H, N), rnd(B, T, H, N), rnd(B, T, H, N)
    logw = -torch.exp(rnd(B, T, H, N) + decay_shift)
    return [r, k, v, logw, rnd(H, N) * 0.5, rnd(B, H, N, N) * s0_scale,
            rnd(B, T, H, N), rnd(B, H, N, N) if dsT else None]


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
        print("k4_bwd_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.rwkv6_wkv import ops as wo
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="k4-variants-"))
    real = wo.build_bwd()
    card = cs.nvidia_smi_line()
    print(json.dumps({"variant": "committed", "card": card,
                      "ptxas": ptxas_report(
                          str(common.build_log["rwkv6_wkv_bwd"]["ptxas"]))}),
          flush=True)
    checks = {"T=130 nonzero s0, dsT": inputs(2, 130, 32, 64, seed=1),
              "strong decay, T=512": inputs(2, 512, 32, 64, seed=3,
                                            decay_shift=2.0)}
    train = inputs(4, 2048, 32, 64, s0_scale=0.0, dsT=False)
    want = {k: wo.wkv6_bwd_plain(*v) for k, v in checks.items()}
    want_train = wo.wkv6_bwd_plain(*train)
    for name in filter(None, args.variants.split(",")):
        path = variant_source(name, workdir)
        lib = common.load_library(f"rwkv6_wkv_bwd_{name}", [path],
                                  [path.parent / "wkv_mma.cuh"])
        lib.wkv6_bwd.argtypes = real.wkv6_bwd.argtypes
        lib.wkv6_bwd.restype = real.wkv6_bwd.restype
        rec = {"variant": name, "card": card, "ptxas": ptxas_report(str(
            common.build_log[f"rwkv6_wkv_bwd_{name}"]["ptxas"]))}

        def use(which):
            wo.build_bwd = (lambda: real) if which == "committed" else (
                lambda: lib)
        try:
            use(name)
            rec["rel_err"] = {k: rel_errors(wo.wkv6_bwd(*v), want[k])
                              for k, v in checks.items()}
            rec["rel_err"]["training shape"] = rel_errors(
                wo.wkv6_bwd(*train), want_train)
            times = {}
            for which in ("committed", name, name + " again",
                          "committed again"):
                use(which.split()[0])
                times[which] = cs.cuda_time_ms(lambda: wo.wkv6_bwd(*train),
                                               iters=10, warmup=2)
            for which in ("committed", name):
                use(which)
                rec[f"{which}_device_ms"] = cs.profiled_groups_ms(
                    lambda: wo.wkv6_bwd(*train),
                    {k: (k,) for k in wo.BWD_KERNEL_NAMES}, iters=10)
            rec["event_ms"] = times
        finally:
            use("committed")
        rec["ok"] = all(v <= 1e-4 for errs in rec["rel_err"].values()
                        for v in errs.values())
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
