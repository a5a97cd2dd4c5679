"""Sharded SAPG driver: D problems × C chains on a ('data', 'chains') mesh
(port of `semiblind_tv_tpu/cli/run_sharded.py`).

The multi-card entry point: one process a rank under `torchrun`, or a
one-process world when started plainly.  Each problem is an independent
image (the reference driver's `for i_im` loop, run_Gaussian_demo.m:100);
chains of the same problem average their SA statistics each step.  Runs
the complete pipeline on the mesh — warm-up, main SAPG scan, per-problem
EB extraction and (unless --no-map) the SALSA MAP solve with the plugged-in
estimates (SAPG_algorithm_Guassian.m:67-306 + run_Gaussian_demo.m:219-242;
kernel A1 at ≤512²), the MAP solves shared out over the ranks.

  python -m semiblind_tv_tpu_torch.cli.run_sharded --psf gaussian --size 512 \\
      --problems 4 --chains-per-shard 4 --samples 300 --warmup 200
  torchrun --nproc-per-node=2 -m semiblind_tv_tpu_torch.cli.run_sharded \\
      --device cpu --size 64 --data 2 --chains-per-shard 2 --samples 200 --warmup 100

`--data` is the mesh's data axis (default 1), the chains axis takes the
rest of the world; `--problems` (default: the data axis) is the number of
problems, a multiple of it, so that one rank can hold several (one kernel
launch a step for all of its chains).  Problem d's torch.Generator,
seeded `--seed` + d, draws its observation noise and then its chains'
noise, so a one-problem run draws as `run_demo --seed` does.  `--bare
--steps N` runs the bare stepper instead (throughput; no warm-up, EB or
MAP).  `--device` defaults to `cuda`; a world larger than the host's cards
raises, with no fallback to the CPU.  A checkpoint in a world of more than
one rank is a directory (the "orbax" backend).  Rank 0 prints the JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
import torch.distributed as dist

from semiblind_tv_tpu_torch.parallel.mesh import CHAINS_AXIS, DATA_AXIS, make_mesh
from semiblind_tv_tpu_torch.parallel.sapg_parallel import (
    run_sapg_sharded,
    run_sapg_sharded_steps,
)
from semiblind_tv_tpu_torch.runtime.config import preset
from semiblind_tv_tpu_torch.runtime.distributed import initialize
from semiblind_tv_tpu_torch.runtime.problem import build_problem, resolve_device
from semiblind_tv_tpu_torch.utils.images import load_image

__all__ = ["main"]


def _map_entry(prob, res, cfg):
    """mse_db, ssim and iterations of the SALSA MAP solve with the EB
    estimates plugged in."""
    from semiblind_tv_tpu_torch.metrics import metrics
    from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv

    dtype, device = prob.blur.dtype, prob.device
    params_EB = {k: torch.tensor(v, dtype=dtype, device=device)
                 for k, v in res.psf_params_EB.items()}
    H_EB = prob.blur.otf_host(prob.model.kernel(params_EB))
    salsa = salsa_tv(prob.y, H_EB, tau=res.theta_EB * res.sigma2_EB,
                     mu=res.theta_EB * cfg.salsa.mu_factor, blur=prob.blur,
                     max_iter=cfg.salsa.outer_iters, tol=cfg.salsa.tol,
                     tv_iters=cfg.salsa.tv_iters, x_true=prob.x_true)
    x = torch.from_numpy(salsa.x).to(device)
    return dict(mse_db=float(metrics.mse_db(prob.x_true, x)),
                ssim=float(metrics.ssim(prob.x_true, x)), salsa_iters=salsa.n_iters,
                mse_db_observation=float(metrics.mse_db(prob.x_true, prob.y)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="gaussian")
    p.add_argument("--image", default="wheel")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--data", type=int, default=None,
                   help="data-axis size (independent problems); default 1")
    p.add_argument("--problems", type=int, default=None,
                   help="problems in all, a multiple of --data (default: --data)")
    p.add_argument("--chains-per-shard", type=int, default=1)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--no-fix-w", action="store_true")
    p.add_argument("--no-map", action="store_true",
                   help="skip the per-problem SALSA MAP solve")
    p.add_argument("--checkpoint", default=None,
                   help="mid-run checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--bare", action="store_true",
                   help="bare stepper (no warm-up/EB/MAP) for throughput")
    p.add_argument("--steps", type=int, default=1000,
                   help="bare-stepper iteration count")
    p.add_argument("--device", default="cuda", help="torch device type (default cuda)")
    args = p.parse_args(argv)

    device_type = resolve_device(args.device).type
    own_world = not dist.is_initialized()   # a one-process world made here
    initialize(device_type)
    n_dev = dist.get_world_size()
    data = args.data if args.data is not None else 1
    if n_dev % data != 0:
        raise SystemExit(f"{n_dev} devices not divisible by data={data}")
    n_problems = args.problems if args.problems is not None else data
    mesh = make_mesh(data=data, chains=n_dev // data, device_type=device_type)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device(device_type))
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    kwargs = {}
    if args.psf == "gaussian" and args.no_fix_w:
        kwargs.update(fix_w1=False, fix_w2=False)
    cfg = preset(args.psf, **kwargs)
    sapg_over = {}
    if args.samples is not None:
        sapg_over.update(samples=args.samples, burn_in=(args.samples * 80) // 100)
    if args.warmup is not None:
        sapg_over["warmup"] = args.warmup
    if sapg_over:
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg_over))
    image = load_image(args.image, size=args.size)
    gens = [torch.Generator(device=device).manual_seed(args.seed + d) for d in range(n_problems)]
    problems = [build_problem(image, cfg, g, device=device) for g in gens]
    shape = {DATA_AXIS: data, CHAINS_AXIS: n_dev // data}
    rank = dist.get_rank()

    if args.bare:
        t0 = time.perf_counter()
        state, thetas = run_sapg_sharded_steps(problems, mesh, gens,
                                               chains_per_shard=args.chains_per_shard,
                                               n_steps=args.steps)
        dt = time.perf_counter() - t0
        out = {
            "mesh": shape, "devices": n_dev, "problems": n_problems,
            "chains_per_problem": state["n_chains"], "steps": args.steps, "wall_s": dt,
            "chain_iters_per_sec": n_problems * state["n_chains"] * args.steps / dt,
            "theta_last": [float(t) for t in thetas[:, -1]],
            "sigma2_last": [float(s) for s in state["sigma2"]],
        }
        if rank == 0:
            print(json.dumps(out, indent=2))
        if own_world:
            dist.destroy_process_group()
        return out

    t0 = time.perf_counter()
    results = run_sapg_sharded(
        problems, mesh, gens, chains_per_shard=args.chains_per_shard,
        checkpoint_every=args.checkpoint_every, checkpoint_path=args.checkpoint,
        checkpoint_backend="orbax" if n_dev > 1 else "npz",
    )
    sapg_dt = time.perf_counter() - t0

    C = results[0].X_last.shape[0]
    total_iters = n_problems * C * (cfg.sapg.samples - 1 + max(cfg.sapg.warmup - 1, 0))
    out = {
        "mesh": shape, "devices": n_dev, "chains_per_problem": C,
        "samples": cfg.sapg.samples, "warmup": cfg.sapg.warmup, "sapg_wall_s": sapg_dt,
        "chain_iters_per_sec": total_iters / sapg_dt, "problems": [],
        "device": torch.cuda.get_device_name(device) if device_type == "cuda" else device_type,
    }
    maps = {}
    if not args.no_map:
        # the MAP solves shared out: problem d on rank d mod world
        mine = {d: _map_entry(problems[d], results[d], cfg)
                for d in range(n_problems) if d % n_dev == rank}
        parts = [None] * n_dev
        if n_dev > 1:
            dist.all_gather_object(parts, mine)
        else:
            parts = [mine]
        for part in parts:
            maps.update(part)
    for d, (prob, res) in enumerate(zip(problems, results)):
        entry = {"theta_EB": res.theta_EB, "sigma2_EB": res.sigma2_EB,
                 "sigma2_true": float(prob.sigma_true) ** 2,
                 "psf_params_EB": res.psf_params_EB}
        entry.update(maps.get(d, {}))
        out["problems"].append(entry)
    if rank == 0:
        print(json.dumps(out, indent=2))
    if own_world:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
