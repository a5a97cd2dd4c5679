"""Chambolle sweeps kernel B ran a chain a call on rank 0, 16 of the 64
chains on each of four cards, as the kernel counts them: the program's
`sweeps.B` over `chain_calls.B` over the traced run's set-up and window
(portbench/program_spans.py)."""
from portbench import program_spans

program_spans.arm()

UNIT = "sweeps/call"
LAYER = "spatial kernel"
MOVES = "chain_iter_per_s"


def read(r):
    return program_spans.sweeps_per_call("B")
