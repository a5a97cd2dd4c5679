"""The whole SAPG iteration's share of one H100's float32 peak on rank 0,
16 of the 64 chains on each of four cards: the operations of rank 0's
chains in the profiled slice's iterations, counted from their shapes
(portbench/work.py: sapg_iter_work, at the reference's sweeps a call over
those chains) over the slice's length (from the trace) times 67 TFLOP/s."""
from portbench import readings

UNIT = "%"
LAYER = "device"
MOVES = "chain_iter_per_s"


def read(r):
    return readings.mfu(r)
