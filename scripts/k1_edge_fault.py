"""Plants a fault in K1's ragged key edge and shows that ``chip_smoke.py``'s
checks see it.  Needs a CUDA card (Hopper) and nvcc.

K1 (``flash_attention.cu``) loads keys in tiles that are zero-filled past
Skv (TMA in the bf16 wgmma kernel, 64-key tiles; cp.async in the float32
TF32 x 3 kernel, 32-key tiles); the kernel must mask every key at or past
``L = min(lengths[b], Skv)``.  The planted faults round L up to the tile
in each tensor-core kernel's mask, so the zero-filled keys of the last
tile enter the softmax (bf16: 63 of them at Skv = 1601, 36 at 1500;
fp32: 31 and 4).  The bf16 fault rounds the item's L (which also loads
the zero-filled tile); the fp32 one widens only the mask, since rows past
the tile's valid keys are never read.  The CUDA-core kernel is not
mutated: it reads keys from global memory, and the same fault there
would read past the tensor.

The script copies ``src/repro_torch`` into a scratch directory, applies
both faults to the copy's K1 source, builds it there, and runs
chip_smoke's Skv != S cases (``chip_smoke.cross_cases``, bf16 and fp32)
through ``chip_smoke.check_flash_case``: once with the shifted keys the
phase uses, once with unshifted ones.  It prints one JSON object and
exits 0 when the faults fail every shifted case.

    python3 scripts/k1_edge_fault.py [--workdir DIR] [--keep]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("repro_torch/kernels/flash_attention/csrc/flash_attention.cu")
# (text, its faulted form): each text occurs once in the source
FAULTS = (
    ("it.L = min(max(L, 0), Skv);",
     "it.L = (min(max(L, 0), Skv) + kFaBKV - 1) / kFaBKV * kFaBKV;"),
    ("const bool seen = kp < L &&",
     "const bool seen = kp < (L + kTfKV - 1) / kTfKV * kTfKV &&"),
)


def plant(workdir: Path) -> Path:
    """A copy of the package under ``workdir/src`` with the faults in K1."""
    src = workdir / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / CU
    text = cu.read_text()
    for mask, fault in FAULTS:
        if text.count(mask) != 1:
            raise SystemExit(f"k1_edge_fault: {mask!r} is not in {CU} once")
        text = text.replace(mask, fault)
    cu.write_text(text)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="scratch directory for the mutated copy (default: "
                         "a new temporary one)")
    ap.add_argument("--keep", action="store_true",
                    help="leave the mutated copy in place")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_edge_fault: no CUDA device is visible", file=sys.stderr)
        return 2
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="k1_edge_fault_"))
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        src = plant(workdir)
        sys.path[:0] = [str(src), str(ROOT)]
        import chip_smoke
        import repro_torch
        assert Path(repro_torch.__file__).is_relative_to(src)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        results = {}
        for shift in (chip_smoke.KEY_SHIFT, 0.0):
            for c in chip_smoke.cross_cases(shift):
                ok, err, tol, amax = chip_smoke.check_flash_case(c)
                results.setdefault(c["name"], {})[f"key_shift {shift}"] = {
                    "passes": ok, "max_abs_err": err, "atol": tol["atol"],
                    "rtol": tol["rtol"], "max_abs_ref": amax}
                print(f"[fault] {c['name']}, keys shifted by {shift}: "
                      f"max_abs_err {err:.3e} at max|ref| {amax:.3f}, "
                      f"atol {tol['atol']:.3e}: the check "
                      f"{'PASSES (misses the fault)' if ok else 'fails'}",
                      flush=True)
        caught = all(not r[f"key_shift {chip_smoke.KEY_SHIFT}"]["passes"]
                     for r in results.values())
        print(json.dumps({"card": card, "faults": [f for _, f in FAULTS],
                          "cases": results, "caught": caught}), flush=True)
        return 0 if caught else 1
    finally:
        if not args.keep:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
