"""Times K1's backward kernel against variants of its own source on one
card, in turns, to back two design choices of its tensor-core path.
Needs a CUDA card (Hopper) and nvcc.

Each variant is the committed ``flash_attention_bwd.cu`` with text
replaced (every replaced text must occur as often as listed), built
beside it from a scratch directory with ``sm90.cuh``:
  * ``zero_fill_hd80``: head dims 80 run on the hd-128 instantiation, as
    K1's forward runs them: the tensor maps cover hd columns, TMA
    zero-fills dims 80-127, and the stores skip the columns past hd (the
    committed kernel runs hd 80 in exact 16-dim chunks);
  * ``round_robin_dkdv``: the dK/dV kernel walks its items round-robin
    instead of snaking.
For the committed kernel and each variant the script prints ptxas's
registers, spills and any serialised wgmma for the tensor-core kernels,
checks the variant against the plain version on danube's training shape
(``chip_smoke.check_bwd_case``), and times each at danube's shape and the
vlm cross shape: device time by kernel from torch.profiler, committed
and variant in turns (committed, variant, variant, committed).  Prints
one JSON object per variant.

    python3 scripts/k1_bwd_variants.py [--variants a,b] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "flash_attention" / "csrc"

# (old, new, count): each old text occurs `count` times in the source
VARIANTS = {
    "zero_fill_hd80": [
        ("    e = launch_wgmma<80>(a);", "    e = launch_wgmma<128>(a);", 1),
        ("HD, a.qs,", "a.hd, a.qs,", 2),
        ("HD, a.dos,", "a.hd, a.dos,", 2),
        ("HD, a.ks,", "a.hd, a.ks,", 2),
        ("HD, a.vs,", "a.hd, a.vs,", 2),
        ("float mul, int t4) {", "float mul, int t4, int hd) {", 1),
        ("      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =",
         "      if (8 * j + 2 * t4 < hd)\n"
         "        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t4) =", 1),
        ("dka, scale, t4);", "dka, scale, t4, hd);", 1),
        ("dva, 1.f, t4);", "dva, 1.f, t4, hd);", 1),
        ("dqa, scale, t4);", "dqa, scale, t4, hd);", 1),
        ("int window, float scale, float scale_log2) {",
         "int window, float scale, float scale_log2, int hd) {", 1),
        ("float scale, float scale_log2) {",
         "float scale, float scale_log2, int hd) {", 1),
        ("a.causal, a.window, a.scale, scale_log2);",
         "a.causal, a.window, a.scale, scale_log2, a.hd);", 2),
    ],
    "round_robin_dkdv": [
        ("(t = walk(n, items, true)) >= 0", "(t = walk(n, items, false)) >= 0",
         2),
    ],
}
SHAPES = ("danube train bf16 causal (B=4, S=2048, window 4096)",
          "vlm cross bf16")


def variant_source(name: str, workdir: Path) -> Path:
    """The variant's source under ``workdir/name`` beside a copy of the
    shared header."""
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for old, new, count in VARIANTS[name]:
        if text.count(old) != count:
            raise SystemExit(f"k1_bwd_variants: {old!r} occurs "
                             f"{text.count(old)} times, not {count}")
        text = text.replace(old, new)
    out = workdir / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "sm90.cuh").write_text((CSRC / "sm90.cuh").read_text())
    (out / "flash_attention_bwd.cu").write_text(text)
    return out


def ptxas_lines(report: str) -> list:
    """Registers and spills of each wgmma kernel, and serialised wgmmas."""
    lines, entry = [], None
    for line in report.splitlines():
        m = re.search(r"(\w+_wgmma_kernel)ILi(\d+)", line)
        if "Compiling entry" in line:
            entry = f"{m.group(1)}<{m.group(2)}>" if m else None
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
        if "wgmma" in line and "serialized" in line:
            lines.append(line.strip())
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--workdir", default=None,
                    help="scratch directory for the variants' sources "
                         "(default: a new temporary one)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_bwd_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="k1-bwd-var-"))
    names = args.variants.split(",")
    ops.build()
    libs = {"committed": ops.build_bwd()}
    for name in names:
        src = variant_source(name, workdir)
        lib = common.load_library(f"k1_bwd_{name}",
                                  [src / "flash_attention_bwd.cu"],
                                  [src / "sm90.cuh"])
        fn = lib.flash_attention_bwd
        fn.argtypes = ops.build_bwd().flash_attention_bwd.argtypes
        fn.restype = ctypes.c_int
        libs[name] = lib
    reports = {"committed": ptxas_lines(
        str(common.build_log["flash_attention_bwd"]["ptxas"]))}
    for name in names:
        reports[name] = ptxas_lines(
            str(common.build_log[f"k1_bwd_{name}"]["ptxas"]))
    card = cs.nvidia_smi_line()
    real = ops.build_bwd
    cases = {c["name"]: c for c in cs.bwd_cases()}

    def use(name):
        ops.build_bwd = lambda: libs[name]

    def timed(name, c, o, lse, do):
        use(name)
        kw = dict(causal=c["causal"], window=c["window"], lengths=None)
        split = cs.profiled_groups_ms(
            lambda: ops.flash_attention_bwd(c["q"], c["k"], c["v"], o, lse,
                                            do, **kw), cs.K1_BWD_SPLIT)
        return {"device_ms": sum(split.values()), "split_ms": split}

    try:
        checks = {}
        for name in names:
            use(name)
            r = cs.check_bwd_case(cases[SHAPES[0]])
            checks[name] = {"ok": cs.bwd_case_ok(r), "rel_l2": r["rel_l2"]}
        times = {name: {} for name in ["committed", *names]}
        for shape in SHAPES:
            c = cases[shape]
            o, lse, do = cs.bwd_inputs(dict(c, lengths=None))
            for name in names:
                runs = [timed(n, c, o, lse, do) for n in
                        ("committed", name, name, "committed")]
                times["committed"].setdefault(shape, []).extend(
                    (runs[0], runs[3]))
                times[name][shape] = runs[1:3]
            del o, lse, do
            torch.cuda.empty_cache()
    finally:
        ops.build_bwd = real
    for name in ["committed", *names]:
        print(json.dumps({"variant": name, "card": card,
                          "check": checks.get(name),
                          "ptxas": reports[name], "times": times[name]}),
              flush=True)
    return 0 if all(v["ok"] for v in checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
