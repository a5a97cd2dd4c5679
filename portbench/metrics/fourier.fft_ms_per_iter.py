"""Device ms of the cuFFT kernels a SAPG iteration at B = 1 (the profiled
slice): the transforms of ops/fourier (one rfft2 and one irfft2 of the
chains a step, and the per-step OTFs where a PSF parameter is free)."""
from portbench import readings

UNIT = "ms/iter"
LAYER = "ops/fourier"
MOVES = "chain_iter_per_s"
KERNELS = (r"fft", r"FFT", r"[Rr]adix", r"[cC]2[rR]", r"[rR]2[cC]")


def read(r):
    return readings.kernel_ms_per_iter(r, KERNELS)
