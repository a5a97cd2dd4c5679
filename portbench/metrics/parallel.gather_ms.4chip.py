"""Median host ms of a run's gather of the chains' last state from every
rank on rank 0: the program's `sapg.gather` spans (all_gather_object over the
chains group, parallel/sapg_parallel.py), those of the set-up's run and of
the window's runs, less any the profiler's session cut
(portbench/program_spans.py).  None where the program has no such span."""
import statistics

from portbench import program_spans

program_spans.arm()

UNIT = "ms"
LAYER = "parallel/sapg_parallel"
MOVES = "chain_iter_per_s"


def read(r):
    snap = program_spans.snapshot()
    if snap is None:
        return None
    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in snap["spans"]
          if s["name"] == "sapg.gather" and not s["profiled"]]
    return statistics.median(ms) if ms else None
