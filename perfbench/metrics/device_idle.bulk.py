"""device_idle.bulk: Share of the traced sub-window with no operation on the
device, in the closed-loop cells, whose throughput it moves."""

from perfbench.harness import readers

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "infer_rows_per_s"


def read(run):
    return readers.device_idle_pct(run)
