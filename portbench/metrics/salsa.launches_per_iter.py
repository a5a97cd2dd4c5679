"""CUDA launch calls the host makes an outer SALSA iteration (runtime and
driver API events of one profiled solve, over its outer iterations)."""
from portbench import readings

UNIT = "launches/iter"
LAYER = "solvers/salsa"
MOVES = "map_solve_s"


def read(r):
    return readings.launches_per_iter(r)
