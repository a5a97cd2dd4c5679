"""Median host ms of a SAPG run on rank 0 outside its warm-up and main-scan
segments, 16 of the 64 chains on each of four cards: the program's
`sapg.run` spans less their `sapg.warmup` and `sapg.segment` children
(prologue, assembly with the gathers from every rank, host copies), over
the window's full runs (portbench/program_spans.py)."""
from portbench import program_spans

program_spans.arm()

UNIT = "ms"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s"


def read(r):
    return program_spans.run_gap_ms()
