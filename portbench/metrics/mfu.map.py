"""The whole SALSA outer iteration's share of the H100's float32 peak: the
operations of one profiled solve's outer iterations counted from their
shapes (portbench/work.py: salsa_iter_work, at the reference's sweeps a
call) over the solve's length (from the trace) times 67 TFLOP/s."""
from portbench import readings

UNIT = "%"
LAYER = "device"
MOVES = "map_solve_s"


def read(r):
    return readings.mfu(r)
