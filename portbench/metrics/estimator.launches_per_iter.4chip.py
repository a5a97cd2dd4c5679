"""CUDA launch calls rank 0's host makes a SAPG iteration, 16 of the 64
chains on each of four cards (runtime and driver API events in the
profiled slice of the first run, over the iterations in it): the sharded
path's eager host loop, which no CUDA graph replaces."""
from portbench import readings

UNIT = "launches/iter"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s"


def read(r):
    return readings.launches_per_iter(r)
