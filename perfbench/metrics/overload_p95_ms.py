"""overload_p95_ms: 95th percentile of every request's latency, from when it
was due to the last byte of its answer, where the offered load is above what
the system sustains.  It tracks the coalescer's queue: the backlog grows all
through the window (offered rows less served rows, times the time), so the
tail is about the backlog at the close over the rate served, and swings with
the window's length and the seed; a per-layer reading, not a bound.  Faster
forwards or fuller batches serve the queue faster, which the overloaded
cell's throughput shows."""

from perfbench.harness import readers

LAYER = "coalescer (serving/coalesce.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "overload_rows_per_s"


def read(run):
    return readers.latency_percentile_ms(run, 95)
