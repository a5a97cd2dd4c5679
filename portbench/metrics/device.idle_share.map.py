"""The device's idle share over one profiled SALSA solve:
1 − (the union of its operations' intervals ÷ the solve's length)."""
from portbench import readings

UNIT = "%"
LAYER = "device"
MOVES = "map_solve_s"


def read(r):
    return readings.idle_share(r)
