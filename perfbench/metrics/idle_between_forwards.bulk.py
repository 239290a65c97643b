"""idle_between_forwards.bulk: Share of the device's time in and between
forwards that it waits between them, on its own clock (CUDA events the
coalescer records before and after each forward call:
``coalesce.device_gap_ms_hist`` over it and ``device_forward_ms_hist``), in
the closed-loop cells, whose throughput it moves."""

from perfbench.harness import stages

LAYER = "coalescer (serving/coalesce.py)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "infer_rows_per_s"


def read(run):
    return stages.idle_between_forwards_pct(run)
