"""Kernel B's share of its roofline at B = 1: the bound of a fused MYULA step
(portbench/work.py: step_work at the chains, the image and the sweeps the
reference's run made a call, summed over the chains, against the H100's
float32 peak and HBM rate) over the device time a SAPG iteration of the
kernels that do the spatial segment (the profiled slice)."""
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
