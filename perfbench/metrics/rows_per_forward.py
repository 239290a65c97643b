"""rows_per_forward: Rows per forward the coalescer formed over the window
(change in rows_total over change in batches_formed)."""

from perfbench.harness import readers

LAYER = "coalescer (serving/coalesce.py)"
UNIT = "rows"
SOURCE = "program_counter"
MOVES = "overload_rows_per_s"


def read(run):
    return readers.rows_per_forward(run)
