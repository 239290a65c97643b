"""idle_between_forwards.interactive: Share of the device's time in and between
forwards that it waits between them, on its own clock
(``coalesce.device_gap_ms_hist`` over it and ``device_forward_ms_hist``), in
the overloaded cell, whose throughput it moves."""

from perfbench.harness import stages

LAYER = "coalescer (serving/coalesce.py)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "overload_rows_per_s"


def read(run):
    return stages.idle_between_forwards_pct(run)
