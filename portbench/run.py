"""Run one cell of the port's benchmark once and print its result.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`semiblind_tv_tpu_torch`)
and a CUDA card.  The last line on standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (with `--trace 0` the cell's
end-to-end metrics, with `--trace 1` its per-layer ones), `device`, with
`--trace 1` `breakdown`, and last `checks`, each number the check compared
beside its limit (also the last lines on standard error).  Without a card,
or with fewer cards than the cell asks for, it prints no result and exits
with another code than 0; it does not fall back to the CPU.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# Import the benchmark as the package `portbench` from the checkout's root,
# and keep this directory off the path: its profile.py would shadow the
# standard library's.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
