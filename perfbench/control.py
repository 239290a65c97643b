"""The control of a cell's check: the plain reference put in the
program's place and computed in float8 e4m3, the precision below the
bfloat16 the configurations serve in, read against the float32 reference
on the rows a run compares (the cell's ``ref_rows``, drawn from its mix
with each seed's weights).  The benchmark's own runs never run it.

  python3 perfbench/control.py --workload yi9b-pair.bulk --seeds 1 2 3

Prints one JSON line per seed: {"seed", "logit_err", "limit",
"control_fails"}.  A control that passes the limit means the limit is too
loose to tell the program from a lower precision.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_rows(mix, n: int):
    """The first ``n`` rows of the mix's requests, in order of sending."""
    import numpy as np
    rows, k = [], 0
    reqs = (mix.schedule(600.0) if mix.loop == "open" else None)
    while len(rows) < n:
        req = reqs[k] if reqs is not None else mix.closed_request(0, k)
        rows.extend(mix.tokens(req))
        k += 1
    return np.stack(rows[:n])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.harness import check, spec
    from perfbench.harness import weights as wmod
    from perfbench.harness.traffic import Mix

    cell = spec.load_cell(args.workload, ROOT)
    cfg = cell.config
    ref = spec.part_module("reference", cfg["reference"])
    layout = wmod.dense_gqa_layout(cfg["arch"])
    C = int(cfg["num_classes"])
    for seed in args.seeds:
        t = time.perf_counter()
        mix = Mix(cell.traffic, seed, cfg["arch"]["vocab_size"])
        tok = torch.from_numpy(control_rows(
            mix, int(cfg["check"]["ref_rows"]))).to(args.device)
        exact, low = [], []
        for i in range(len(cfg["members"])):
            w = wmod.make(layout, seed, i, args.device)
            exact.append(ref.class_logits(w, tok, cfg["arch"], C)
                         .double().cpu().numpy())
            low.append(ref.class_logits(w, tok, cfg["arch"], C,
                                        precision="fp8")
                       .double().cpu().numpy())
            del w
        err = check.logit_err(low, exact)
        limit = float(cfg["check"]["limits"]["logit_err"])
        print(json.dumps({"seed": seed, "logit_err": err, "limit": limit,
                          "control_fails": err > limit,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
