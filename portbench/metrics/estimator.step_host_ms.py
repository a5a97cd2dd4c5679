"""Median host ms of a main-scan SAPG iteration at B = 1: the program's own
`sapg.step` spans (noise draw to trace store) of the traced run's set-up
and of its first run before the profiled slice: the profiler's session
slows the host after it (portbench/program_spans.py)."""
from portbench import program_spans

program_spans.arm()

UNIT = "ms"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s"


def read(r):
    return program_spans.median_ms("sapg.step")
