"""Device ms an iteration of NCCL's kernels on rank 0 in the profiled slice
of SAPG iterations, 16 of the 64 chains on each of four cards: the
all_reduce of the SA statistics (problem_means), which on the device also
waits for the slowest rank to arrive.  None where the slice holds no NCCL
kernel."""
from portbench import readings

UNIT = "ms/iter"
LAYER = "NCCL collectives"
MOVES = "chain_iter_per_s"


def read(r):
    return readings.kernel_ms_per_iter(r, [r"nccl"])
