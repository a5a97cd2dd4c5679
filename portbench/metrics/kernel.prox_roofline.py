"""Kernel A1's share of its roofline in SALSA: the bound of its warm prox
(portbench/work.py: prox_work with the duals read and written, at the
sweeps the reference's solve made a call) over A1's device time an outer
iteration (one profiled solve)."""
from portbench import readings
from portbench.work import prox_work

UNIT = "%"
LAYER = "spatial kernel"
MOVES = "map_solve_s"
KERNELS = (r"^resident_prox",)


def work(r):
    return prox_work(1, *r["shape"], r["sweeps"], duals_io=True)


def read(r):
    return readings.roofline(r, KERNELS, work)
