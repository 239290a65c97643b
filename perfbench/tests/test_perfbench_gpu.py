"""One short run of a cell on the card, as the driver runs it: the
command from the root of the checkout, its last line the result.  Skips
without a card (decided inside the test).  On the card:

  python -m pytest -q -p no:cacheprovider -m gpu perfbench/tests
"""

import json
import subprocess
import sys

import pytest

from perfbench.harness import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_one_short_run_of_a_cell(card):
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "danube-pair.long", "--seed", str(2**31 + 17), "--seconds", "5",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, proc.stderr[-3000:]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert set(out["metrics"]) == {"infer_rows_per_s", "infer_p95_ms",
                                   "infer_p50_ms", "setup_s"}
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
