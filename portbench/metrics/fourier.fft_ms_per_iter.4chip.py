"""Device ms of the cuFFT kernels a SAPG iteration on rank 0's card, 16 of
the 64 chains on each of four cards (the profiled slice): one rfft2 and one
irfft2 of the rank's chains a step."""
from portbench import readings

UNIT = "ms/iter"
LAYER = "ops/fourier"
MOVES = "chain_iter_per_s"
KERNELS = (r"fft", r"FFT", r"[Rr]adix", r"[cC]2[rR]", r"[rR]2[cC]")


def read(r):
    return readings.kernel_ms_per_iter(r, KERNELS)
