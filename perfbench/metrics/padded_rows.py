"""padded_rows: Share of the rows the forwards of the window ran that were
padding (rows the batcher added to reach a bucket), from the batches the
members' readouts were given."""

from perfbench.harness import readers

LAYER = "batcher (core/batching.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "overload_rows_per_s"


def read(run):
    return readers.padded_rows_pct(run)
