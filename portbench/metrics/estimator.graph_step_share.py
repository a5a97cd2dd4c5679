"""Share of the SAPG iterations (warm-up and main) at B = 1 that ran as a
replay of a captured CUDA graph, in %: the program's always-on counters
`graph.replays` over `graph.replays` + `graph.eager_steps`, over the traced
run's set-up and window (portbench/program_spans.py).  None where the
program has no such counters."""
from portbench import program_spans

program_spans.arm()

UNIT = "%"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s"


def read(r):
    snap = program_spans.snapshot()
    if snap is None:
        return None
    replays = snap["counters"].get("graph.replays", 0)
    total = replays + snap["counters"].get("graph.eager_steps", 0)
    return 100.0 * replays / total if total else None
