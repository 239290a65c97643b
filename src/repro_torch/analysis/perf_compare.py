"""Performance comparison: roofline dirs or benchmark artifacts (the port
of ``repro/analysis/perf_compare.py``).

Two modes share this CLI:

Roofline mode (``--base``/``--opt`` directories): reads two dry-run
result directories of ``repro_torch.launch.dryrun`` (e.g.
results/dryrun_base with --opts none, results/dryrun_opt with --opts
all) and prints per-pair deltas of the three roofline terms (the H100's,
``analysis/roofline.py``) + the dominant-term verdict; the mesh is one
card's, "gpu1".

Artifact mode (two positional ``BENCH_<scenario>.json`` files: a
``scenario``, a ``commit``, ``medians`` rows of ``name`` and
``us_per_call``, and ``self_checks`` rows of ``name`` and ``passed``):
diffs the medians row by row and the self-check verdicts, and exits
non-zero when any median regressed more than ``--threshold`` (default
10%) or a self-check that passed in the baseline fails (or is gone) in
the candidate:

  PYTHONPATH=src python -m repro_torch.analysis.perf_compare BENCH_A.json BENCH_B.json
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis import roofline


def _load(dir_path: str) -> Dict[tuple, roofline.RooflineRow]:
    out = {}
    for rec in roofline.load_results(dir_path):
        row = roofline.analyze(rec)
        if row is not None:
            out[(row.arch, row.shape, row.mesh)] = row
    return out


def _fmt(x: float) -> str:
    if x >= 1.0:
        return f"{x:7.2f}s "
    if x >= 1e-3:
        return f"{x * 1e3:7.2f}ms"
    return f"{x * 1e6:7.1f}us"


def compare(base_dir: str, opt_dir: str, mesh: Optional[str] = "gpu1",
            only: Optional[list] = None) -> str:
    base = _load(base_dir)
    opti = _load(opt_dir)
    hdr = (f"{'arch x shape':44s} {'term':9s} {'baseline':10s} "
           f"{'optimized':10s} {'gain':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for key in sorted(base):
        if mesh and key[2] != mesh:
            continue
        if only and (key[0], key[1]) not in only:
            continue
        b, o = base[key], opti.get(key)
        if o is None:
            continue
        name = f"{key[0]} x {key[1]}"
        for term in ("compute_s", "memory_s", "collective_s"):
            bv, ov = getattr(b, term), getattr(o, term)
            # one card has no collective term: 0 against 0 is no change
            gain = bv / ov if ov > 0 else (1.0 if bv == 0 else float("inf"))
            mark = " <-- dominant" if term[:-2] == b.dominant else ""
            lines.append(f"{name:44s} {term[:-2]:9s} {_fmt(bv)} {_fmt(ov)} "
                         f"{gain:6.2f}x{mark}")
            name = ""
        bb = (b.bytes_per_chip or 0) / 2 ** 30
        ob = (o.bytes_per_chip or 0) / 2 ** 30
        lines.append(f"{'':44s} {'GiB/chip':9s} {bb:9.2f} {ob:10.2f} "
                     f"{'fits Y' if o.fits_hbm else 'fits N'}")
    return "\n".join(lines)


def _load_artifact(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "medians" not in doc:
        raise SystemExit(f"{path}: not a BENCH_<scenario>.json artifact "
                         f"(missing 'medians')")
    return doc


def compare_artifacts(base: Dict[str, Any], cand: Dict[str, Any],
                      threshold_pct: float = 10.0
                      ) -> Tuple[str, List[str]]:
    """Diff two benchmark artifacts -> (report text, regression list).

    A median regresses when the candidate's us_per_call exceeds the
    baseline's by more than ``threshold_pct``; a self-check regresses
    when it passed in the baseline but fails (or disappears) in the
    candidate.  Rows present on only one side are reported, not failed.
    """
    regressions: List[str] = []
    b_rows = {r["name"]: r for r in base.get("medians", [])}
    c_rows = {r["name"]: r for r in cand.get("medians", [])}
    hdr = (f"{'benchmark':44s} {'baseline':>11s} {'candidate':>11s} "
           f"{'delta':>8s}")
    lines = [f"# {base.get('scenario', '?')}: "
             f"{base.get('commit', '?')[:12]} -> "
             f"{cand.get('commit', '?')[:12]}",
             hdr, "-" * len(hdr)]
    for name in sorted(b_rows.keys() | c_rows.keys()):
        b, c = b_rows.get(name), c_rows.get(name)
        if b is None or c is None:
            lines.append(f"{name:44s} "
                         f"{'-' if b is None else format(b['us_per_call'], '9.1f') + 'us':>11s} "
                         f"{'-' if c is None else format(c['us_per_call'], '9.1f') + 'us':>11s} "
                         f"{'new' if b is None else 'gone':>8s}")
            continue
        bv, cv = float(b["us_per_call"]), float(c["us_per_call"])
        delta_pct = 100.0 * (cv - bv) / bv if bv > 0 else 0.0
        mark = ""
        if delta_pct > threshold_pct:
            mark = " <-- REGRESSED"
            regressions.append(
                f"median {name!r}: {bv:.1f}us -> {cv:.1f}us "
                f"(+{delta_pct:.1f}% > {threshold_pct:.0f}%)")
        lines.append(f"{name:44s} {bv:9.1f}us {cv:9.1f}us "
                     f"{delta_pct:+7.1f}%{mark}")
    b_checks = {c["name"]: c.get("passed", False)
                for c in base.get("self_checks", [])}
    c_checks = {c["name"]: c.get("passed", False)
                for c in cand.get("self_checks", [])}
    for name in sorted(b_checks.keys() | c_checks.keys()):
        was, now = b_checks.get(name), c_checks.get(name)
        verdict = {True: "pass", False: "FAIL", None: "-"}
        mark = ""
        if was is True and now is not True:
            mark = " <-- REGRESSED"
            regressions.append(f"self-check {name!r}: pass -> "
                               f"{'missing' if now is None else 'fail'}")
        lines.append(f"{'check: ' + name:44s} {verdict[was]:>11s} "
                     f"{verdict[now]:>11s} {'':>8s}{mark}")
    return "\n".join(lines), regressions


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Compare two dry-run directories or two benchmark "
                    "artifacts.")
    ap.add_argument("artifacts", nargs="*", metavar="BENCH.json",
                    help="two benchmark artifacts (baseline, candidate) "
                         "for artifact-diff mode; omit for roofline mode")
    ap.add_argument("--base", default="results/dryrun_base")
    ap.add_argument("--opt", default="results/dryrun_opt")
    ap.add_argument("--mesh", default="gpu1")
    ap.add_argument("--threshold", type=float, default=10.0,
                    help="artifact mode: %% median regression that fails "
                         "the comparison (default 10)")
    args = ap.parse_args(argv)
    if args.artifacts:
        if len(args.artifacts) != 2:
            ap.error("artifact mode takes exactly two BENCH_*.json files")
        report, regressions = compare_artifacts(
            _load_artifact(args.artifacts[0]),
            _load_artifact(args.artifacts[1]),
            threshold_pct=args.threshold)
        print(report)
        if regressions:
            print(f"\n{len(regressions)} regression(s):")
            for r in regressions:
                print(f"  - {r}")
            return 1
        print("\nno regressions")
        return 0
    print(compare(args.base, args.opt, mesh=args.mesh))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
