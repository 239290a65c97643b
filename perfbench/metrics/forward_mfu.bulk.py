"""forward_mfu.bulk: Useful model FLOPs of the rows forwarded in the window
over the forwards' time (forward_ms_hist) at the bf16 peak, in the closed-loop
cells, whose throughput it moves."""

from perfbench.harness import readers

LAYER = "model step (core/ensemble.py, models/transformer.py)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "infer_rows_per_s"


def read(run):
    return readers.forward_mfu_pct(run)
