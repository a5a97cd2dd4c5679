"""Median host ms of the PSF/OTF path of a SAPG iteration with the PSF free:
the program's `psf.otf` spans (the kernel, its gradients and their OTFs)
of the traced run's set-up and of its first run before the profiled slice
(portbench/program_spans.py)."""
from portbench import program_spans

program_spans.arm()

UNIT = "ms"
LAYER = "sapg/estimator"
MOVES = "chain_iter_per_s"


def read(r):
    return program_spans.median_ms("psf.otf")
