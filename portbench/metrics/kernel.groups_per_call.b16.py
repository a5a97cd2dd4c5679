"""Chain groups kernel B ran one after another a call at B = 16: the
program's always-on counters `groups.B` over `launches.B`, over the traced
run's set-up and window (portbench/program_spans.py).  8 where each block
holds one chain's tile (two chains at once on an H100 at 512²), fewer where
a block holds the tiles of several chains.  None where the program has no
`groups.B` counter (a tree from before it) or launched no kernel B."""
from portbench import program_spans

program_spans.arm()

UNIT = "groups/call"
LAYER = "spatial kernel"
MOVES = "chain_iter_per_s.b16"


def read(r):
    snap = program_spans.snapshot()
    if snap is None:
        return None
    groups = snap["counters"].get("groups.B", 0)
    launches = snap["counters"].get("launches.B", 0)
    return groups / launches if groups and launches else None
