"""CUDA launch calls the host makes a SAPG iteration at B = 16 (runtime and
driver API events in the profiled slice of the first run, over the
iterations in it): the estimator's host loop."""
from portbench import readings

UNIT = "launches/iter"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s.b16"


def read(r):
    return readings.launches_per_iter(r)
