"""overload_rows_per_s: Rows answered with 200 per second of the window (to the
last answer of a request it sent) where the offered load is above what the
system sustains: the work completed, not the rate offered."""

from perfbench.harness import readers

LAYER = "HTTP front end (serving/server.py)"
UNIT = "rows/s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return readers.rows_per_s(run)
