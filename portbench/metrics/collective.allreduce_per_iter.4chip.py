"""all_reduce calls an iteration on rank 0 over the traced run's set-up and
window: the program's always-on counter `collective.all_reduce.calls`
(sapg/estimator.py's problem_means across ranks) over the warm-up and SAPG
iterations run (`graph.replays` + `graph.eager_steps`); the design's one a
step, plus one a run for the initial logπ (portbench/program_spans.py).
None where the program has no such counter."""
from portbench import program_spans

program_spans.arm()

UNIT = "calls/iter"
LAYER = "NCCL collectives"
MOVES = "chain_iter_per_s"


def read(r):
    snap = program_spans.snapshot()
    if snap is None:
        return None
    n = snap["counters"]
    calls = n.get("collective.all_reduce.calls", 0)
    iters = n.get("graph.replays", 0) + n.get("graph.eager_steps", 0)
    return calls / iters if calls and iters else None
