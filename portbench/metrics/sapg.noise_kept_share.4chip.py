"""Share of the Langevin noise rank 0 drew that its chains used, in %: the
program's always-on counters `noise.kept` over `noise.drawn` (elements,
parallel/sapg_parallel.py's draw), over the traced run's set-up and window
(portbench/program_spans.py).  Every rank draws the whole (64, M, N) field
a step and keeps its 16 chains' rows, so 25% on four cards.  None where
the program has no such counters."""
from portbench import program_spans

program_spans.arm()

UNIT = "%"
LAYER = "parallel/sapg_parallel"
MOVES = "chain_iter_per_s"


def read(r):
    snap = program_spans.snapshot()
    if snap is None or not snap["counters"].get("noise.drawn"):
        return None
    return 100.0 * snap["counters"].get("noise.kept", 0) / snap["counters"]["noise.drawn"]
