"""Median host ms of a SAPG run outside its warm-up and main-scan segments
at B = 1: the program's `sapg.run` spans less their `sapg.warmup` and
`sapg.segment` children (prologue, assembly, host copies), over the window's
full runs (portbench/program_spans.py)."""
from portbench import program_spans

program_spans.arm()

UNIT = "ms"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s"


def read(r):
    return program_spans.run_gap_ms()
