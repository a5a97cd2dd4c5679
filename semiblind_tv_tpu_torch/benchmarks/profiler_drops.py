"""How often a torch.profiler session around one call of a resident kernel
(A1, A2, B, C at 512² B=1) records no kernel although the call ran.

    python3 semiblind_tv_tpu_torch/benchmarks/profiler_drops.py [--reps 150] [--pads 0 0.002 0 0.002]

For each pad (seconds of idle host time inside the profiled window, before
the call and after its synchronize) it opens `reps` one-call sessions of
each of the four calls, in turn, and prints one JSON line: the card's name
and power limit, the pad, the sessions opened, and for each call the
sessions whose listing was not exactly one kernel launched once (with the
first few of them).  `chip_smoke.py` takes a reading again when it holds no
kernel; this script measures why it must.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=150)
    ap.add_argument("--pads", type=float, nargs="+", default=[0.0, 0.002, 0.0, 0.002])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

    import torch

    if not torch.cuda.is_available():
        print("profiler_drops: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from semiblind_tv_tpu_torch import _build
    from semiblind_tv_tpu_torch.benchmarks.probe_prox_variants import card_line
    from semiblind_tv_tpu_torch.ops import fused_step_cuda, tv_cuda

    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    g = (100.0 + 5.0 * torch.randn((1, 512, 512), generator=gen, device=dev)).contiguous()
    lam = torch.tensor(0.02, device=dev)
    px0 = torch.zeros_like(g)
    sc = (torch.tensor(1.9, device=dev), torch.tensor(2.0, device=dev), lam)
    seeds = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    calls = {
        "A1": lambda: tv_cuda.chambolle_prox_cuda(g, lam, 10, duals=(px0, px0)),
        "A2": lambda: tv_cuda.chambolle_prox_cuda(g, lam, 25, return_state=False),
        "B": lambda: fused_step_cuda.myula_prox_tv(g, g, px0, px0, *sc, 25),
        "C": lambda: fused_step_cuda.myula_prox_tv_rng(g, g, px0, seeds, *sc, 25),
    }
    card = card_line()
    for pad in args.pads:
        bad = {name: [] for name in calls}
        t0 = time.perf_counter()
        for rep in range(args.reps):
            for name, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    time.sleep(pad)
                    fn()
                    torch.cuda.synchronize()
                    time.sleep(pad)
                ks = [(e.key.split("(")[0], e.count) for e in prof.key_averages()
                      if e.device_time_total > 0]
                if not (len(ks) == 1 and ks[0][1] == 1):
                    bad[name].append((rep, ks))
        print(json.dumps({"card": card, "pad_s": pad, "sessions": args.reps * len(calls),
                          "bad": {k: len(v) for k, v in bad.items()},
                          "first": {k: v[:3] for k, v in bad.items() if v},
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
