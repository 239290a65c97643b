"""dispatch_stall_ms.interactive: Per forward, the time the coalescer's
dispatch thread held work and did not run: wall less CPU time of its
``coalesce.collect``, ``merge`` and ``scatter`` stages, in the overloaded
cell, whose throughput it moves. Where the host's thread CPU clock moves in
10 ms steps (the H100 machines measured so far), the CPU part is a sample
and the reading is noisy by about a millisecond."""

from perfbench.harness import stages

LAYER = "coalescer (serving/coalesce.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "overload_rows_per_s"


def read(run):
    return stages.dispatch_stall_ms(run)
