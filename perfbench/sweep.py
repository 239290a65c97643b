"""One point of an open-loop cell's rate sweep: the cell run at another
offered rate than its mix fixes, to find the knee, the highest rate at
which the coalescer's queue stays flat over the window.  The benchmark's
own runs never run it; a cell keeps the rate its traffic file fixes.

  python3 perfbench/sweep.py --workload yi9b-pair.interactive --rate 9 \\
      --seed 5 --seconds 20

Prints one JSON line: the rate, the rows answered per second, p50 and p95
latency, and ``trend``, the median latency of the window's last third
over its first third (about 1 where the queue stays flat, growing with a
backlog).
"""

import argparse
import json
import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np

    from perfbench.harness import bench, readers, spec

    cell = spec.load_cell(args.workload, ROOT)
    if cell.traffic["loop"] != "open":
        raise SystemExit(f"{args.workload} is not an open loop")
    cell.traffic["rate_per_s"] = args.rate
    cell.end_to_end = cell.per_layer = []
    out, lines, run = bench.run(cell, args.seed, args.seconds, False,
                                args.device, T0,
                                log=lambda m: print(m, file=sys.stderr))
    lat = [(r.due, r.latency_s) for r in run.results if r.ok]
    lat.sort()
    third = max(1, len(lat) // 3)
    first = np.median([x for _, x in lat[:third]])
    last = np.median([x for _, x in lat[-third:]])
    print(json.dumps({
        "rate_per_s": args.rate, "correct": out["correct"],
        "attempted": out["attempted"], "failed": out["failed"],
        "rows_per_s": readers.rows_per_s(run),
        "p50_ms": readers.latency_percentile_ms(run, 50),
        "p95_ms": readers.latency_percentile_ms(run, 95),
        "rows_per_forward": readers.rows_per_forward(run),
        "forward_mfu_pct": readers.forward_mfu_pct(run),
        "trend": float(last / first)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
