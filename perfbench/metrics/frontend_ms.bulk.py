"""frontend_ms.bulk: A request's mean wall time in the front end:
``frontend.parse`` (the body in hand to the coalescer: JSON, context,
admission, the batch) plus ``frontend.respond`` (its release by the
dispatcher to the last byte written), in the closed-loop cells, whose
throughput it moves."""

from perfbench.harness import stages

LAYER = "HTTP front end (serving/server.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "infer_rows_per_s"


def read(run):
    return stages.frontend_ms(run)
