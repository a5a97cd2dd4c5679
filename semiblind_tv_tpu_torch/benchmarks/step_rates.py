"""SAPG step rates at 512² (chip_smoke.py's phase 4) of the port in a given
checkout, so that two trees can be compared on one card within one call.

    python3 semiblind_tv_tpu_torch/benchmarks/step_rates.py [--root DIR] [--chains 1 16]

Imports `semiblind_tv_tpu_torch` from DIR (default: the checkout that holds
this file), builds its kernels there, and prints one JSON line: the card's
name and power limit, DIR, and the chain-iter/s of the default route (the
Gaussian preset with w free, wheel.png 512², 200 steps after 20 warm-up,
as phase 4) for each B.  Run it on two trees in turn (A, B, B, A): a step
at B=1 is host-bound and moves ±25% between processes.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="checkout whose semiblind_tv_tpu_torch is measured")
    ap.add_argument("--chains", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--warm", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("step_rates: needs a CUDA card", file=sys.stderr)
        return 1
    from semiblind_tv_tpu_torch import _build
    from semiblind_tv_tpu_torch.runtime.config import gaussian_preset
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.sapg.estimator import (
        generator_noise,
        generator_seeds,
        make_sapg_step,
    )
    from semiblind_tv_tpu_torch.utils.images import load_image

    if not os.path.abspath(_build.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    wheel = load_image(os.path.join(root, "data", "images", "wheel.png"))
    prob = build_problem(wheel, gaussian_preset(fix_w1=False, fix_w2=False), gen, device=dev)

    rates = {}
    for B in args.chains:
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        step, aux = make_sapg_step(prob, B)
        shape = (B,) + prob.blur.shape
        if aux["in_kernel_rng"](B):
            seeds = generator_seeds(g, dev)
            draw = lambda: seeds(B)  # noqa: E731
        else:
            noise = generator_noise(g, prob.blur.dtype, dev)
            draw = lambda: noise(shape)  # noqa: E731
        X = prob.y.expand(shape).contiguous()
        prox = aux["prox_b"](X, aux["lam"] * aux["theta0"])[0]
        carry = (X, prob.blur.rfft(X), prox, aux["theta0"], prob.sigma2_init,
                 dict(aux["params0"]))
        for ii in range(2, 2 + args.warm):
            carry, _ = step(carry, ii, draw())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ii in range(2 + args.warm, 2 + args.warm + args.steps):
            carry, _ = step(carry, ii, draw())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(carry[0]).all()):
            raise RuntimeError(f"non-finite chain state at B={B}")
        rates[str(B)] = args.steps * B / dt
    print(json.dumps({"card": card_line(), "root": root, "chain_iter_per_s": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
