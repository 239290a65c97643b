"""batcher_padded_rows: Share of the rows the window's forwards ran that were
padding, from the batcher's own counters (``ensemble_batches``:
``padded_rows_total`` over it and ``rows_total``)."""

from perfbench.harness import stages

LAYER = "batcher (core/batching.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "overload_rows_per_s"


def read(run):
    return stages.batcher_padded_rows_pct(run)
