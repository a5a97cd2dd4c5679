"""Share of the SAPG iterations (warm-up and main) at B = 1 whose Parseval
statistics ran as the hand-written kernel, in %: the program's always-on
counters `launches.sapg_stats` over `graph.replays` + `graph.eager_steps`,
over the traced run's set-up and window (portbench/program_spans.py).  A
run adds one launch outside its iterations (logπ at the warm-up's end), so
a run of 3,498 iterations reads 100.03%.  None where the program has no
such counter (a tree from before the kernel) or ran no iteration."""
from portbench import program_spans

program_spans.arm()

UNIT = "%"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s"


def read(r):
    snap = program_spans.snapshot()
    if snap is None:
        return None
    launches = snap["counters"].get("launches.sapg_stats", 0)
    iters = snap["counters"].get("graph.replays", 0) + snap["counters"].get("graph.eager_steps", 0)
    return 100.0 * launches / iters if launches and iters else None
