"""frontend_ms.interactive: A request's mean wall time in the front end:
``frontend.parse`` plus ``frontend.respond``, in the overloaded cell, whose
throughput it moves."""

from perfbench.harness import stages

LAYER = "HTTP front end (serving/server.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "overload_rows_per_s"


def read(run):
    return stages.frontend_ms(run)
