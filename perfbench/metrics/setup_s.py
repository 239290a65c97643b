"""setup_s: Process start to the first due request: imports, weights, the
kernels' build or load, warm-up."""

LAYER = "the whole process"
UNIT = "s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.setup_s
