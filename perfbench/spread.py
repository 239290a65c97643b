"""How far the runs of a cell spread: the rule the bounds in
``BENCHMARK.json`` were set by.

  python3 perfbench/spread.py SET1_RESULT... -- SET2_RESULT...

Each argument is a file whose last line is a run's JSON result; the two
sets are the same seeds run twice.  For every metric prints each set's
median and spread (the distance between the first and third quartiles
of ``statistics.quantiles(values, n=4)`` as a share of the median), the
spread with each set's run farthest from its median left out, and five
times the wider spread (at least 1%, at most 25%): the bound that rule
gives.  ``setup_s`` leaves out each set's first run (the one that
builds the kernels) and takes 0.25 whatever its spread.
"""

import json
import statistics
import sys
from typing import Dict, List


def load(paths) -> List[Dict[str, float]]:
    out = []
    for p in paths:
        with open(p) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        res = json.loads(lines[-1])
        out.append({k: v["value"] for k, v in res["metrics"].items()})
    return out


def spread(values: List[float]) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed(values: List[float]) -> List[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv) -> int:
    if "--" not in argv:
        raise SystemExit(__doc__)
    cut = argv.index("--")
    sets = [load(argv[:cut]), load(argv[cut + 1:])]
    for name in sorted(set(sets[0][0]) & set(sets[1][0])):
        vals = [[r[name] for r in s] for s in sets]
        if name == "setup_s":
            vals = [v[1:] for v in vals]
        meds = [statistics.median(v) for v in vals]
        sp = [spread(v) for v in vals]
        tight = [spread(trimmed(v)) for v in vals]
        bound = (0.25 if name == "setup_s"
                 else min(0.25, max(0.01, 5 * max(sp))))
        print(json.dumps({
            "metric": name, "medians": meds,
            "second_vs_first": meds[1] / meds[0] - 1, "spreads": sp,
            "spreads_trimmed": tight, "bound": bound}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
