"""Plants faults in K4's and K5's backward kernels and shows that
``chip_smoke.py``'s checks see each one.  Needs a CUDA card (Hopper) and
nvcc.

Seven faults, one at a time, each in a scratch copy of ``src/repro_torch``;
the K4 ones in the tensor-core route of ``rwkv6_wkv_bwd.cu``, the one the
model's shapes take:
  * ``wkv_bonus_dk``: the u bonus dropped from dk (dk = dk' alone);
  * ``wkv_dlogw_anchor``: dlogw's anchor dropped, the chunk's end state
    against the adjoint from the later chunks (at the last chunk sum_m
    S_T dsT): dlogw keeps only the reverse sums;
  * ``wkv_carry``: the adjoint's boundary scan carries it across a chunk
    boundary without the chunk's decay (G <- G + ... in place of exp(L_c)
    o G + ...);
  * ``wkv_subchunk``: the factor exp(L_e - L_s) dropped from the k side
    of A's factored product between sub-chunks (A[t, s] = (r_t o
    exp(L_{t-1} - L_e)) . k_s);
  * ``ssd_carry`` (``mamba2_ssd_bwd.cu``): the adjoint's boundary scan
    carries it across a chunk boundary without the chunk's decay (Gc <-
    Gc + ... in place of exp(L_c) Gc + ...);
  * ``ssd_dl_cross`` (``mamba2_ssd_bwd.cu``): dl's cross term (the
    chunk's inputs s < t against its own dy C^T at tau >= t) dropped;
  * ``ssd_group_head`` (``mamba2_ssd_bwd.cu``): the second head of every
    head group dropped from the group's sum of dB.
For each (and for the unmutated copy, the control), a subprocess builds
the copy's kernels and runs chip_smoke's phase 3 backward cases of the
mutated kernel (``wkv_bwd_kernel_phase`` or ``ssd_bwd_kernel_phase``) and
phase 13 C for its family (``recurrent_grads``: the family at full
width and the depth of chip_smoke's ``RECUR_GRAD_LAYERS``, float32 and
bf16 gradients against the plain versions within ``RECUR_GRAD_BOUNDS``); the
control runs both kernels and both families.  Each fault must fail phase
3 (some case) and phase 13 C; the control must pass both.  Prints one
JSON object per run and a summary, and exits 0 when every fault was
caught and the control passed.  ``--rwkv6-layers 2,8`` also runs rwkv6's
phase 13 C at those depths (reported, not judged: the verdict is at
chip_smoke's ``RECUR_GRAD_LAYERS``).

    python3 scripts/recurrent_bwd_fault.py [--workdir DIR] [--faults a,b]
        [--rwkv6-layers 2,4,8,24]
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
WKV = Path("repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_bwd.cu")
SSD = Path("repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd_bwd.cu")
# fault -> (source, text, its replacement)
FAULTS = {
    "wkv_bonus_dk": (WKV,
                     "c.x + rv.x * uv.x * vdy, c.y + rv.y * uv.y * vdy,\n"
                     "        c.z + rv.z * uv.z * vdy, "
                     "c.w + rv.w * uv.w * vdy);",
                     "c.x, c.y, c.z, c.w);"),
    "wkv_dlogw_anchor": (WKV,
                         "float acc = __expf(L[(kChunk - 1) * kLd + n]) *\n"
                         "                    (tl.sg[0][n] + tl.sg[1][n] + "
                         "tl.sg[2][n] + tl.sg[3][n]) +\n"
                         "                sm.qpart[0][n] + sm.qpart[1][n];",
                         "float acc = 0.f;"),
    "wkv_carry": (WKV, "const float d0 = __expf(Lc[wr + g]), "
                       "d1 = __expf(Lc[wr + g + 8]);",
                  "const float d0 = fwd ? __expf(Lc[wr + g]) : 1.f,\n"
                  "                d1 = fwd ? __expf(Lc[wr + g + 8]) : 1.f;"),
    "wkv_subchunk": (WKV, "bv[0] = kv.x * __expf(le.x - ls.x);\n"
                          "            bv[1] = kv.y * __expf(le.y - ls.y);",
                     "bv[0] = kv.x;\n            bv[1] = kv.y;"),
    "ssd_carry": (SSD, "const float carry = __expf(fminf(Lc, 0.f));",
                  "const float carry = fwd ? __expf(fminf(Lc, 0.f)) : 1.f;"),
    "ssd_dl_cross": (SSD, "const float dl = base + esuf + fpre + rect;",
                     "const float dl = base + esuf + fpre;"),
    "ssd_group_head": (SSD,
                       "dB_acc[j2][i] += dB_h[j2][i] + dB_e[j2][i];",
                       "dB_acc[j2][i] += hi == 1 ? 0.f : "
                       "dB_h[j2][i] + dB_e[j2][i];"),
}
FAMILY = {WKV: "rwkv6-1.6b", SSD: "zamba2-2.7b"}


def plant(workdir: Path, fault: str) -> Path:
    """A copy of the package under ``workdir/<fault>/src`` with the fault
    planted (none for ``control``)."""
    src = workdir / fault / "src"
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault != "control":
        path, old, new = FAULTS[fault]
        cu = src / path
        text = cu.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"recurrent_bwd_fault: {old!r} is not in "
                             f"{path} once")
        cu.write_text(text.replace(old, new))
    return src


def run_checks(src: str, fault: str, depths: str = "") -> int:
    """In a subprocess: phase 3's backward cases and phase 13 C for the
    mutated kernel (both for the control) against the package under
    ``src``; rwkv6's 13 C also at each of ``depths`` (comma-separated
    layer counts)."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba2_ssd import ops as so
    from repro_torch.kernels.rwkv6_wkv import ops as wo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    which = ([FAULTS[fault][0]] if fault != "control" else [WKV, SSD])
    for build in (wo.build, wo.build_bwd, so.build, so.build_bwd):
        build()
    if SSD in which:                     # zamba2's shared block: K1
        fa.build()
        fa.build_bwd()
    out = {"fault": fault, "card": cs.nvidia_smi_line()}
    for path in which:
        phase3 = []
        entry = (cs.wkv_bwd_kernel_phase if path == WKV
                 else cs.ssd_bwd_kernel_phase)(phase3)
        arch = FAMILY[path]
        phase13 = []
        grads = cs.recurrent_grads(phase13, arch)
        sweep = {}
        if path == WKV:
            own = cs.RECUR_GRAD_LAYERS[arch]
            for layers in filter(None, depths.split(",")):
                cs.RECUR_GRAD_LAYERS[arch] = int(layers)
                g = cs.recurrent_grads([], arch)
                sweep[layers] = {dt: {k: g[dt][k] for k in (
                    "loss_diff", "rel_l2_max", "worst_leaf", "ratio_max",
                    "ratio_leaf") if k in g[dt]}
                    for dt in ("float32", "bfloat16")}
                torch.cuda.empty_cache()
            cs.RECUR_GRAD_LAYERS[arch] = own
        out[arch] = {
            "depth_sweep": sweep,
            "phase3_failed": [c["case"] for c in entry["cases"]
                              if not c["ok"]],
            "phase3": [{k: c[k] for k in ("case", "rel_err", "ok")}
                       for c in entry["cases"]],
            "phase13c_failed": bool(phase13),
            "phase13c": {dt: {k: r[k] for k in (
                "loss_diff", "rel_l2_max", "worst_leaf", "ratio_max",
                "ratio_leaf", "bounds") if k in r}
                for dt, r in grads.items() if dt != "layers"}}
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default=None,
                    help="scratch directory for the mutated copies "
                         "(default: a new temporary one)")
    ap.add_argument("--faults", default="control," + ",".join(FAULTS))
    ap.add_argument("--rwkv6-layers", default="",
                    help="comma-separated depths at which rwkv6's phase "
                         "13 C also runs (reported only)")
    ap.add_argument("--run", nargs=3, metavar=("SRC", "FAULT", "DEPTHS"),
                    help=argparse.SUPPRESS)     # the subprocess's mode
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("recurrent_bwd_fault: no CUDA device is visible",
              file=sys.stderr)
        return 2
    if args.run:
        return run_checks(*args.run)
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="recur-fault-"))
    results = {}
    for fault in args.faults.split(","):
        src = plant(workdir, fault)
        proc = subprocess.run(
            [sys.executable, __file__, "--run", str(src), fault,
             args.rwkv6_layers],
            capture_output=True, text=True, timeout=1800)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            results[fault] = None
            continue
        print(line[-1], flush=True)
        results[fault] = json.loads(line[-1])

    def failed(r, arch):
        return bool(r[arch]["phase3_failed"]) and r[arch]["phase13c_failed"]
    caught = {f: r is not None and failed(r, FAMILY[FAULTS[f][0]])
              for f, r in results.items() if f != "control"}
    control = results.get("control")
    control_ok = "control" not in results or (control is not None and not any(
        control[a]["phase3_failed"] or control[a]["phase13c_failed"]
        for a in FAMILY.values()))
    print(json.dumps({"caught": caught, "control_passed": control_ok}),
          flush=True)
    return 0 if all(caught.values()) and control_ok else 1


if __name__ == "__main__":
    sys.exit(main())
