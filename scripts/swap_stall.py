"""Times where a ``/v1/infer`` request waits while a version hot-loads.

Runs ``chip_smoke.py``'s phase 8 (the control plane on store-loaded yi-9b
versions at full width, 8 layers) against the ``repro_torch`` package
under ``--src`` (default: this checkout's ``src``), so that two trees
(a parent and a change) can be compared in one call on one card.  Phase 8
C sends an 8-row ``/v1/infer`` every 100 ms while ``POST
/v1/models/{name}/load`` reads, verifies, uploads and warms a 3.8 GB
version; the script prints its numbers as one JSON object: the load's
parts (read, verify, upload, warm; ms), the requests that overlapped the
load, the largest ``coalesce_queue`` and ``coalesce_forward`` span among
them, and the slowest response during the load.  Needs a CUDA card and
nvcc.

    python3 scripts/swap_stall.py [--src DIR] [--label NAME]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch to run")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("swap_stall: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    fa_ops.build()
    da_ops.build()
    failures = []
    kernels = [{} for _ in range(5)]
    chip_smoke.control_plane_phase(failures, kernels, None)
    swap = kernels[0]["control_plane"].get("swap", {})
    print(json.dumps({"label": args.label, "src": args.src,
                      "card": chip_smoke.nvidia_smi_line(),
                      "seconds": time.perf_counter() - t0,
                      "failures": failures, "swap": swap}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
