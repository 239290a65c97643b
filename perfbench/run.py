"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

  python3 perfbench/run.py --workload yi9b-pair.bulk --seed 7 \\
      --seconds 51 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is the run's JSON result; the
numbers the check compared, each beside its limit, are the last lines of
standard error.  With ``--trace 1`` the result carries the cell's
per-layer metrics, the device's busy time and a breakdown; otherwise its
end-to-end metrics.  Exits non-zero, with no result, where no card or too
few are visible, where the program cannot be imported, and where a module
of JAX or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root: the port builds its kernels under build/kernels/
# there, at a fixed path, by itself
ROOT = Path(__file__).resolve().parents[1]

# Where the interpreter is told to write no bytecode (PYTHONDONTWRITEBYTECODE)
# and the installed packages hold none, every run would compile each module of
# torch anew: seconds of set-up that swing with the host's load.  Bytecode goes
# instead to a fixed directory inside the checkout, written by its first run
# and read by every later one.
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from perfbench.harness import bench, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program (repro_torch) cannot be imported: {e}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    out, lines, _ = bench.run(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0,
                           log=lambda m: print(m, file=sys.stderr))
    found = bench.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
