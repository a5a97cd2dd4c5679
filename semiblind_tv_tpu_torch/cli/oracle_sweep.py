"""Oracle sweep validation of the EB estimates (port of
`semiblind_tv_tpu/cli/oracle_sweep.py`).

The reference's `SALSA/salsa_m.m:234-326` and `salsa_m_sigma.m:196-234`:
after (optionally) running SAPG, grid the regularisation parameter (and
σ²), run the SALSA MAP solve at every grid point against the ground truth,
find the MSE-minimising *oracle* value, and report it beside the EB
estimate — the reference's check that empirical Bayes lands near the
oracle.  Each SALSA solve takes the warm-dual prox route of
`solvers/salsa.py::resolve_salsa_prox_mode` (kernel A1 up to 512²), the
SAPG run the port's step kernels.

Usage:
  python -m semiblind_tv_tpu_torch.cli.oracle_sweep --psf gaussian --size 128 \
      --samples 2000 --warmup 1000 --grid 15

`--device` defaults to `cuda`; a CUDA request on a machine without a card
raises.  One torch.Generator on the device, seeded with `--seed`, draws the
observation noise and then the chains' noise (as `run_demo` does).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Sequence

import numpy as np
import torch

from semiblind_tv_tpu_torch.metrics import metrics
from semiblind_tv_tpu_torch.runtime.config import preset
from semiblind_tv_tpu_torch.runtime.problem import build_problem, resolve_device
from semiblind_tv_tpu_torch.sapg.estimator import run_sapg
from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv
from semiblind_tv_tpu_torch.utils.images import load_image

__all__ = ["oracle_sweep", "tau_sweep", "build_parser", "main"]


def _sweep(problem, salsa_cfg, psf_params, taus_mus):
    """MSE(dB) of the SALSA MAP solve at each (τ, µ), and the argmin."""
    params = psf_params or {
        k: torch.tensor(v, dtype=problem.blur.dtype, device=problem.device)
        for k, v in problem.cfg.true_psf_params().items()
    }
    H = problem.blur.otf_host(problem.model.kernel(params))
    mses = []
    for tau, mu in taus_mus:
        res = salsa_tv(problem.y, H, tau=tau, mu=mu, blur=problem.blur,
                       max_iter=salsa_cfg.outer_iters, tol=salsa_cfg.tol,
                       tv_iters=salsa_cfg.tv_iters, x_true=problem.x_true)
        x = torch.from_numpy(res.x).to(problem.device)
        mses.append(float(metrics.mse_db(problem.x_true, x)))
    mses = np.asarray(mses)
    return mses, int(np.argmin(mses))


def oracle_sweep(problem, thetas: Sequence[float], sigma2: float, salsa_cfg, psf_params=None):
    """MSE(dB) of the SALSA MAP solve for each θ of the grid, with
    τ = θ·σ² and µ = θ·mu_factor — how the demos plug the EB estimates into
    SALSA (run_Gaussian_demo.m:219-230).  Returns (mses_db, oracle_theta,
    oracle_mse_db)."""
    mses, i = _sweep(problem, salsa_cfg, psf_params,
                     [(float(th) * sigma2, float(th) * salsa_cfg.mu_factor) for th in thetas])
    return mses, float(thetas[i]), float(mses[i])


def tau_sweep(problem, taus: Sequence[float], salsa_cfg, psf_params=None):
    """Direct τ-grid sweep — the reference's `Tau_op` loop
    (SALSA/salsa_m.m:234-280): SALSA at each raw τ (no θ·σ² coupling),
    µ = τ·mu_factor.  Returns (mses_db, oracle_tau, oracle_mse_db)."""
    mses, i = _sweep(problem, salsa_cfg, psf_params,
                     [(float(t), float(t) * salsa_cfg.mu_factor) for t in taus])
    return mses, float(taus[i]), float(mses[i])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="gaussian")
    p.add_argument("--image", default="wheel")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--samples", type=int, default=2000)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--grid", type=int, default=11)
    p.add_argument("--theta-min", type=float, default=None)
    p.add_argument("--theta-max", type=float, default=None)
    p.add_argument("--no-sapg", action="store_true",
                   help="sweep only (uses true sigma^2, skips EB estimation)")
    p.add_argument("--sigma-grid", type=int, default=0,
                   help="also sweep sigma^2 over N log-spaced points "
                        "(salsa_m_sigma.m capability)")
    p.add_argument("--tau-grid", type=int, default=0,
                   help="also sweep raw tau directly over N log-spaced "
                        "points, decoupled from theta (salsa_m.m Tau_op)")
    p.add_argument("--tau-min", type=float, default=None)
    p.add_argument("--tau-max", type=float, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # full-precision fp32 matmuls and convolutions (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = resolve_device(args.device)

    cfg = preset(args.psf)
    cfg = dataclasses.replace(
        cfg,
        seed=args.seed,
        sapg=dataclasses.replace(
            cfg.sapg, samples=args.samples, warmup=args.warmup,
            burn_in=(args.samples * 80) // 100,
        ),
    )
    image = load_image(args.image, size=args.size)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    problem = build_problem(image, cfg, gen, device=device)

    out = {"psf": args.psf, "size": args.size}
    if args.no_sapg:
        theta_EB = None
        sigma2 = float(problem.sigma_true) ** 2
    else:
        sapg = run_sapg(problem, gen)
        theta_EB = sapg.theta_EB
        sigma2 = sapg.sigma2_EB
        out.update(theta_EB=theta_EB, sigma2_EB=sigma2)

    lo = args.theta_min if args.theta_min is not None else cfg.theta.box[0]
    hi = args.theta_max if args.theta_max is not None else cfg.theta.box[1]
    grid = np.exp(np.linspace(np.log(lo), np.log(hi), args.grid))
    mses, oracle_theta, oracle_mse = oracle_sweep(problem, grid, sigma2, cfg.salsa)
    out.update(
        theta_grid=[float(t) for t in grid],
        mse_db_curve=[float(m) for m in mses],
        oracle_theta=oracle_theta,
        oracle_mse_db=oracle_mse,
    )
    if theta_EB is not None:
        eb_mses, _, _ = oracle_sweep(problem, [theta_EB], sigma2, cfg.salsa)
        out["eb_mse_db"] = float(eb_mses[0])

    if args.tau_grid > 0:
        # the direct Tau_op sweep (salsa_m.m:234-280); the default range
        # spans the θ box times σ²_true
        s2_true = float(problem.sigma_true) ** 2
        t_lo = args.tau_min if args.tau_min is not None else cfg.theta.box[0] * s2_true
        t_hi = args.tau_max if args.tau_max is not None else cfg.theta.box[1] * s2_true
        tgrid = np.exp(np.linspace(np.log(t_lo), np.log(t_hi), args.tau_grid))
        tmses, oracle_tau, oracle_tau_mse = tau_sweep(problem, tgrid, cfg.salsa)
        out.update(
            tau_grid=[float(t) for t in tgrid],
            tau_mse_db_curve=[float(m) for m in tmses],
            oracle_tau=oracle_tau,
            oracle_tau_mse_db=oracle_tau_mse,
        )
        if theta_EB is not None:
            out["tau_EB"] = float(theta_EB * sigma2)

    if args.sigma_grid > 0:
        # σ² sweep at the best θ (salsa_m_sigma.m:196-234): τ = θ·σ² over a
        # log grid spanning the BSNR-derived box
        th = out.get("theta_EB") or oracle_theta
        s_lo, s_hi = float(problem.sigma2_box[0]), float(problem.sigma2_box[1])
        sgrid = np.exp(np.linspace(np.log(s_lo), np.log(s_hi), args.sigma_grid))
        smses = [float(oracle_sweep(problem, [th], float(s2), cfg.salsa)[0][0]) for s2 in sgrid]
        i = int(np.argmin(smses))
        out.update(
            sigma2_grid=[float(s) for s in sgrid],
            sigma2_mse_db_curve=smses,
            oracle_sigma2=float(sgrid[i]),
            oracle_sigma2_mse_db=smses[i],
            sigma2_true=float(problem.sigma_true) ** 2,
        )
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
