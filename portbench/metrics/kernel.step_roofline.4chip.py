"""Kernel B's share of its roofline on rank 0's card, 16 of the 64 chains on
each of four cards: the bound of a fused MYULA step (portbench/work.py:
step_work at rank 0's chains, the image and the sweeps the reference's
block of those chains made a call) over the device time a SAPG iteration
of the kernels that do the spatial segment (the profiled slice)."""
from portbench import readings
from portbench.work import step_work

UNIT = "%"
LAYER = "spatial kernel"
MOVES = "chain_iter_per_s"
KERNELS = (r"^resident_step",)


def work(r):
    return step_work(r["chains"], *r["shape"], r["sweeps"])


def read(r):
    return readings.roofline(r, KERNELS, work)
