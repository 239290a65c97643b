"""Plants faults in K1's backward kernel and shows that ``chip_smoke.py``'s
checks see each one.  Needs a CUDA card (Hopper) and nvcc.

Three faults, one at a time, each in a scratch copy of ``src/repro_torch``
(``flash_attention_bwd.cu``; both the tensor-core and the CUDA-core kernels
go through the helpers mutated):
  * ``diagonal``: the causal diagonal off by one (``kp <= qp`` becomes
    ``kp < qp``: every query loses its own key in the backward);
  * ``delta``: the Delta term dropped (dS = P * dP);
  * ``last_tile``: the last 64-key tile of every row's keys skipped.
For each (and for the unmutated copy, the control), a subprocess builds
the copy's kernels and runs chip_smoke's phase 3 backward cases
(``chip_smoke.bwd_cases`` through ``check_bwd_case``) and phase 12 B
(``chip_smoke.gradient_phase``: h2o-danube-1.8b at full width and depth,
float32 and bf16 gradients against the plain versions, and bf16's
distance from the plain float32 gradients against the plain bf16
versions', within ``GRAD_BOUNDS``).  Each fault must fail phase 3 (some
case) and phase 12 B; the control must pass both.  Prints one JSON object per run and a
summary, and exits 0 when every fault was caught and the control passed.

    python3 scripts/k1_bwd_fault.py [--workdir DIR] [--faults a,b,c]
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
CU = Path("repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu")
FAULTS = {
    "diagonal": ("(!causal || kp <= qp)", "(!causal || kp < qp)"),
    "delta": ("return p * (dp - delta);", "return p * dp;"),
    "last_tile": ("  return min(max(L, 0), Skv);",
                  "  const int n = min(max(L, 0), Skv);\n"
                  "  return n > 64 ? (n - 1) / 64 * 64 : n;"),
}


def plant(workdir: Path, fault: str) -> Path:
    """A copy of the package under ``workdir/<fault>/src`` with the fault
    in K1's backward (none for ``control``)."""
    src = workdir / fault / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault != "control":
        cu = src / CU
        text = cu.read_text()
        old, new = FAULTS[fault]
        if text.count(old) != 1:
            raise SystemExit(f"k1_bwd_fault: {old!r} is not in {CU} once")
        cu.write_text(text.replace(old, new))
    return src


def run_checks(src: str, fault: str) -> int:
    """In a subprocess: phase 3's backward cases and phase 12 B against
    the package under ``src``."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.build()
    ops.build_bwd()
    cases = []
    for c in cs.bwd_cases():
        r = cs.check_bwd_case(c)
        cases.append({"case": r["case"], "ok": cs.bwd_case_ok(r),
                      "max_abs_err": r["max_abs_err"], "errs": r["errs"],
                      "rel_l2": r["rel_l2"]})
        del c
        torch.cuda.empty_cache()
    failures = []
    grads = cs.gradient_phase(failures)
    out = {"fault": fault, "card": cs.nvidia_smi_line(),
           "phase3_failed": [c["case"] for c in cases if not c["ok"]],
           "phase3": cases,
           "phase12b_failed": bool(failures),
           "phase12b": {dt: {k: r[k] for k in (
               "loss_diff", "rel_l2_max", "worst_leaf", "ratio_max",
               "ratio_leaf", "vs_float32", "bounds") if k in r}
               for dt, r in grads.items()}}
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="scratch directory for the mutated copies "
                         "(default: a new temporary one)")
    ap.add_argument("--faults", default="control," + ",".join(FAULTS))
    ap.add_argument("--run", nargs=2, metavar=("SRC", "FAULT"),
                    help=argparse.SUPPRESS)     # the subprocess's mode
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_bwd_fault: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.run:
        return run_checks(*args.run)
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="k1-bwd-fault-"))
    results = {}
    for fault in args.faults.split(","):
        src = plant(workdir, fault)
        proc = subprocess.run(
            [sys.executable, __file__, "--run", str(src), fault],
            capture_output=True, text=True, timeout=1800)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            results[fault] = None
            continue
        res = json.loads(line[-1])
        print(line[-1], flush=True)
        results[fault] = res
    caught = {f: r is not None and (bool(r["phase3_failed"])
                                    and r["phase12b_failed"])
              for f, r in results.items() if f != "control"}
    control = results.get("control")
    control_ok = "control" not in results or (
        control is not None and not (control["phase3_failed"]
                                     or control["phase12b_failed"]))
    print(json.dumps({"caught": caught, "control_passed": control_ok}),
          flush=True)
    return 0 if all(caught.values()) and control_ok else 1


if __name__ == "__main__":
    sys.exit(main())
