"""infer_p95_ms: 95th percentile of every request's latency, from when it was
due to the last byte of its answer."""

from perfbench.harness import readers

LAYER = "HTTP front end (serving/server.py)"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return readers.latency_percentile_ms(run, 95)
