"""End-to-end demo — the reference's run_{Gaussian,laplace,moffat}_demo.m
(port of `semiblind_tv_tpu/cli/run_demo.py`).

Pipeline (run_Gaussian_demo.m:91-301):
  load image → build problem (observation synthesis, Lipschitz, MYULA steps)
  → SAPG estimation of (theta, PSF params, sigma²)
  → SALSA MAP solve with the plugged-in EB estimates
  → MSE(dB)/SSIM/SNR/PSNR vs ground truth → results JSON

Usage:
  python -m semiblind_tv_tpu_torch.cli.run_demo --psf gaussian --size 512 \
      --samples 20000 --warmup 15000 --chains 1 --out results/gaussian
  python -m semiblind_tv_tpu_torch.cli.run_demo --psf gaussian --no-fix-w \
      --image synthetic --size 2048 --samples 2000 --warmup 1500 --sigma-log-scale

Above 512² the SAPG step and both proxes run the temporally-blocked
kernels (ops/tv_blocked_cuda.py, ops/fused_step_cuda.myula_prox_tv_blocked).
`--fft-mode dft` runs the transforms as dense DFT matmuls (and, at ≤256²
with ≤2 chains, the step as kernel D); `--in-kernel-rng` draws the Langevin
noise inside the step kernel (kernel C up to 512², the blocked kernel's
seeds form at ≥2048²).

`--device` defaults to `cuda`; a CUDA request on a machine without a card
raises.  Flags of the JAX CLI that are not ported yet are absent.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from semiblind_tv_tpu_torch.metrics import metrics
from semiblind_tv_tpu_torch.runtime.config import preset
from semiblind_tv_tpu_torch.runtime.problem import build_problem, resolve_device
from semiblind_tv_tpu_torch.sapg.estimator import run_sapg
from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv
from semiblind_tv_tpu_torch.utils.images import load_image

__all__ = ["run_demo", "main", "resolve_device"]


def run_demo(
    cfg,
    image: np.ndarray,
    n_chains: int = 1,
    dtype=torch.float32,
    device="cuda",
    obs_noise=None,
    noise: Optional[Callable] = None,
    plain: bool = False,
):
    """Run the full experiment; returns (results dict, SAPGResult,
    SALSAResult, Problem).

    One torch.Generator on `device`, seeded from cfg.seed, draws the
    observation noise and then the chains' noise.  `obs_noise` (a
    standard-normal field of the image's shape) and `noise` (a chain-noise
    source, see sapg/estimator.py) replace those draws — the tests inject
    the JAX package's draws through them.  plain=True runs the kernels'
    plain PyTorch versions on any device (the kernel-vs-plain comparison
    on the card)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    problem = build_problem(image, cfg, gen, dtype=dtype, device=device, noise=obs_noise)

    t0 = time.perf_counter()
    sapg = run_sapg(problem, gen, n_chains=n_chains, noise=noise,
                    route="plain" if plain else None)
    sapg_time = time.perf_counter() - t0

    theta_EB = sapg.theta_EB
    sigma2_EB = sapg.sigma2_EB
    params_EB = {
        k: torch.tensor(v, dtype=dtype, device=device) for k, v in sapg.psf_params_EB.items()
    }

    # MAP solve with the plugged-in estimates (run_Gaussian_demo.m:209-242):
    # tau = theta_EB * sigma2_EB, mu = theta_EB/10
    H_EB = problem.blur.otf_host(problem.model.kernel(params_EB))
    t0 = time.perf_counter()
    salsa = salsa_tv(
        problem.y,
        H_EB,
        tau=theta_EB * sigma2_EB,
        mu=theta_EB * cfg.salsa.mu_factor,
        blur=problem.blur,
        max_iter=cfg.salsa.outer_iters,
        tol=cfg.salsa.tol,
        tv_iters=cfg.salsa.tv_iters,
        stop_criterion=cfg.salsa.stop_criterion,
        x_true=problem.x_true,
        prox_route="plain" if plain else None,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    salsa_time = time.perf_counter() - t0

    x_true = problem.x_true
    x_map = torch.as_tensor(salsa.x).to(device)
    results = {
        "psf": cfg.psf,
        "theta_EB": theta_EB,
        "sigma2_EB": sigma2_EB,
        "psf_params_EB": {k: float(v) for k, v in sapg.psf_params_EB.items()},
        "true_psf_params": cfg.true_psf_params(),
        "sigma2_true": float(problem.sigma_true) ** 2,
        "mse_db": float(metrics.mse_db(x_true, x_map)),
        "ssim": float(metrics.ssim(x_true, x_map)),
        "snr_db": float(metrics.snr(x_true, x_map)),
        "psnr_db": float(metrics.psnr(x_true, x_map)),
        "mse_db_observation": float(metrics.mse_db(x_true, problem.y)),
        "sapg_time_s": sapg_time,
        "salsa_time_s": salsa_time,
        "salsa_iters": salsa.n_iters,
        "salsa_op_counts": salsa.op_counts,
        "n_chains": n_chains,
        "samples": cfg.sapg.samples,
        "warmup": cfg.sapg.warmup,
        "lambda": float(problem.lambda_myula),
        "gamma": float(problem.gamma),
        "Lf": float(problem.Lf),
        "ev_max": float(problem.ev_max),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    return results, sapg, salsa, problem


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--psf", choices=["gaussian", "laplace", "moffat"], default="gaussian")
    p.add_argument("--image", default="wheel")
    p.add_argument("--image-dir", default=None)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--bsnr", type=float, default=30.0)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--f64", action="store_true",
                   help="float64, with --device cpu (the CUDA kernels are float32)")
    p.add_argument("--out", default=None, help="directory for results.json")
    p.add_argument("--no-fix-w", action="store_true",
                   help="gaussian: estimate w1/w2 instead of pinning to truth")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--sigma-log-scale", action="store_true",
                   help="log-space sigma^2 SA updates (an extension, off = the "
                        "reference's linear dynamics): moves far faster from the wide "
                        "BSNR-midpoint init on large images")
    p.add_argument("--psf-log-scale", action="store_true",
                   help="log-space SA updates of the free PSF parameters (an extension, "
                        "off = the reference's linear dynamics)")
    p.add_argument("--fft-mode", choices=["fft", "dft"], default=None,
                   help="hot-loop transforms: torch.fft (cuFFT, the default) or dense "
                        "DFT matmuls")
    p.add_argument("--in-kernel-rng", action="store_true",
                   help="draw the Langevin noise inside the step kernel from per-chain "
                        "seeds (an extension: a different, equally valid noise "
                        "realisation; off on the CPU and at 1024²)")
    args = p.parse_args(argv)

    kwargs = {}
    if args.psf == "gaussian" and args.no_fix_w:
        kwargs.update(fix_w1=False, fix_w2=False)
    cfg = preset(args.psf, **kwargs)
    cfg = dataclasses.replace(cfg, bsnr=args.bsnr, seed=args.seed, image=args.image)
    sapg_over = {}
    if args.samples is not None:
        sapg_over["samples"] = args.samples
        sapg_over["burn_in"] = (args.samples * 80) // 100
    if args.warmup is not None:
        sapg_over["warmup"] = args.warmup
    if args.fft_mode is not None:
        sapg_over["fft_mode"] = args.fft_mode
    if args.in_kernel_rng:
        sapg_over["in_kernel_rng"] = True
    if args.sigma_log_scale:
        sapg_over["sigma_log_scale"] = True
    if args.psf_log_scale:
        sapg_over["psf_log_scale"] = True
    if sapg_over:
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg_over))

    # full-precision fp32 matmuls and convolutions (no TF32) — the
    # counterpart of the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    dtype = torch.float64 if args.f64 else torch.float32
    image = load_image(args.image, args.image_dir, size=args.size)
    results, _, _, _ = run_demo(
        cfg, image, n_chains=args.chains, dtype=dtype, device=args.device
    )
    print(json.dumps(results, indent=2))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
