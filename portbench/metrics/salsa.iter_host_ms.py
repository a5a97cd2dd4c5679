"""Median host ms of an outer SALSA iteration: the program's `salsa.iter`
spans of the traced run's set-up and of the warm-up solve before the
profiled one (portbench/program_spans.py)."""
from portbench import program_spans

program_spans.arm()

UNIT = "ms"
LAYER = "solvers/salsa"
MOVES = "map_solve_s"


def read(r):
    return program_spans.median_ms("salsa.iter")
