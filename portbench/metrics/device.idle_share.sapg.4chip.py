"""Rank 0's card's idle share over the profiled slice of SAPG iterations,
16 of the 64 chains on each of four cards: 1 − (the union of its
operations' intervals ÷ the slice's length)."""
from portbench import readings

UNIT = "%"
LAYER = "device"
MOVES = "chain_iter_per_s"


def read(r):
    return readings.idle_share(r)
