"""The whole SAPG iteration's share of the H100's float32 peak at B = 16: the
operations of the profiled slice's iterations counted from their shapes
(portbench/work.py: sapg_iter_work, at the reference's sweeps a call) over
the slice's length (from the trace) times 67 TFLOP/s."""
from portbench import readings

UNIT = "%"
LAYER = "device"
MOVES = "chain_iter_per_s.b16"


def read(r):
    return readings.mfu(r)
