"""The control of a cell's `correct`: the reference put in the program's place
and computed one precision below the configuration's (TF32 fields for
float32, reference/precision.py), compared with the reference by the cell's
own numbers and limits.  A sound limit lets the control fail.

    python -m portbench.control --workload <cell> --seeds 1 2 3 [--program]

prints one JSON line a seed: the control's numbers beside the cell's
limits, whether it came out correct (it must not), and the seconds each
side of the reference took.  It runs the window's first unit of work (run 0
or the solve) at the cell's own size, on the card.  `--program` also
prints, a seed, the program's own numbers from one unit of the cell's work
(the window driver's set-up, a window of one unit and its check), the readings
the limits are set above.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness
from portbench.drivers import map_solves, sapg_runs
from portbench.reference.precision import tf32


def control(c, ref=None):
    """[(name, control's number, limit)] and the seconds of both references;
    `ref`: the reference's outputs where a driver's check has them."""
    t0 = time.perf_counter()
    if c.traffic["driver"] == "map_solves":
        ref, _ = ref or map_solves.reference_solve(c)
        t1 = time.perf_counter()
        low, _ = map_solves.reference_solve(c, q=tf32)
        checks = map_solves.judged(c, low, ref)
    else:
        ref = ref or sapg_runs.reference_run(c, 0)
        t1 = time.perf_counter()
        checks = sapg_runs.judged(c, sapg_runs.reference_run(c, 0, q=tf32), ref)
    return checks, t1 - t0, time.perf_counter() - t1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.manifest(held=True)
    for seed in args.seeds:
        c = harness.cell(bench, args.workload, seed, args.device)
        if args.program:
            drv = harness.driver(c)
            drv.setup()
            win = drv.window(0.0, False)
            drv.release()
            checks = drv.check()
            print(json.dumps({"workload": args.workload, "seed": seed, "side": "program",
                              "correct": harness.judge(checks, win["failed"]),
                              "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
                              "metrics": win["metrics"]}), flush=True)
        checks, t_ref, t_low = control(c, drv.ref if args.program else None)
        print(json.dumps({"workload": args.workload, "seed": seed, "side": "control",
                          "correct": harness.judge(checks, 0),
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
                          "reference_s": t_ref, "control_s": t_low}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
