"""Median host ms of a main-scan SAPG iteration on rank 0, 16 of the 64
chains on each of four cards: the program's own `sapg.step` spans (noise
draw to trace store, the step's all_reduce enqueued inside it) of the
traced run's set-up and of its first run before the profiled slice: the
profiler's session slows the host after it (portbench/program_spans.py)."""
from portbench import program_spans

program_spans.arm()

UNIT = "ms"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s"


def read(r):
    return program_spans.median_ms("sapg.step")
