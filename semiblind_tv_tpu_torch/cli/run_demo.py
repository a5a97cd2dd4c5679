"""End-to-end demo — the reference's run_{Gaussian,laplace,moffat}_demo.m
(port of `semiblind_tv_tpu/cli/run_demo.py`).

Pipeline (run_Gaussian_demo.m:91-301):
  load image → build problem (observation synthesis, Lipschitz, MYULA steps)
  → SAPG estimation of (theta, PSF params, sigma²)
  → SALSA (or FISTA) MAP solve with the plugged-in EB estimates
  → MSE(dB)/SSIM/SNR/PSNR vs ground truth → results JSON, traces.npz
    (+ optional trace plots)

Usage:
  python -m semiblind_tv_tpu_torch.cli.run_demo --psf gaussian --size 512 \
      --samples 20000 --warmup 15000 --chains 1 --out results/gaussian
  python -m semiblind_tv_tpu_torch.cli.run_demo --psf gaussian --no-fix-w \
      --image synthetic --size 2048 --samples 2000 --warmup 1500 --sigma-log-scale
  python -m semiblind_tv_tpu_torch.cli.run_demo --solver fista --out results/fista --plots

Above 512² the SAPG step and both proxes run the temporally-blocked
kernels (ops/tv_blocked_cuda.py, ops/fused_step_cuda.myula_prox_tv_blocked).
`--fft-mode dft` runs the transforms as dense DFT matmuls (and, at ≤256²
with ≤2 chains, the step as kernel D); `--in-kernel-rng` draws the Langevin
noise inside the step kernel (kernel C up to 512², the blocked kernel's
seeds form at ≥2048²).

`--solver fista` solves the MAP problem by TV-FISTA (solvers/fista.py)
instead of SALSA.  `--out DIR` writes results.json and traces.npz
(runtime/checkpoint.save_results); `--plots` adds the reference's figure set
there and needs matplotlib.  A long run resumes from a checkpoint through
`run_demo(cfg, image, checkpoint_every=N, checkpoint_path=PATH)`.

`--mesh DxC` runs the SAPG phase on a ('data', 'chains') mesh
(parallel/sapg_parallel.py) and `--space-mesh S` row-splits the image over
a ('space',) mesh (parallel/spatial.run_sapg_spatial; it forces
fft_mode='dft' and one chain); the MAP solve then runs on each rank.  On
`cuda` the world must hold the mesh: start the ranks with `torchrun
--nproc-per-node=D*C` (or S), or run a 1x1 mesh in one process; a world
smaller than the mesh raises, with no fallback to the CPU.  With `--device
cpu` and no world set up, the CLI starts the mesh's gloo processes itself
(the counterpart of the JAX CLI's virtual CPU mesh); rank 0 prints and
writes the results.

`--device` defaults to `cuda`; a CUDA request on a machine without a card
raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from semiblind_tv_tpu_torch.metrics import metrics
from semiblind_tv_tpu_torch.runtime.checkpoint import save_results
from semiblind_tv_tpu_torch.runtime.config import preset
from semiblind_tv_tpu_torch.runtime.problem import build_problem, resolve_device
from semiblind_tv_tpu_torch.sapg.estimator import run_sapg
from semiblind_tv_tpu_torch.solvers.fista import fista_tv
from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv
from semiblind_tv_tpu_torch.utils.images import load_image

__all__ = ["run_demo", "save_plots", "main", "resolve_device"]


def run_demo(
    cfg,
    image: np.ndarray,
    n_chains: int = 1,
    dtype=torch.float32,
    device="cuda",
    obs_noise=None,
    noise: Optional[Callable] = None,
    plain: bool = False,
    solver: str = "salsa",
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    mesh=None,
    space_mesh=None,
):
    """Run the full experiment; returns (results dict, SAPGResult,
    SALSAResult or FISTAResult, Problem).

    solver: 'salsa' (reference demos) or 'fista' (reference my_deblur_fista
    legacy path) for the MAP solve.
    checkpoint_every/checkpoint_path: run_sapg's mid-run checkpointing; a
    second call with the same checkpoint_path resumes the SAPG phase where
    the checkpoint left it (without the warm-up) and then solves the MAP
    problem.

    One torch.Generator on `device`, seeded from cfg.seed, draws the
    observation noise and then the chains' noise.  `obs_noise` (a
    standard-normal field of the image's shape) and `noise` (a chain-noise
    source, see sapg/estimator.py) replace those draws — the tests inject
    the JAX package's draws through them.  plain=True runs the kernels'
    plain PyTorch versions on any device (the kernel-vs-plain comparison
    on the card).

    mesh: a ('data', 'chains') DeviceMesh — the SAPG phase runs sharded
    over its chains axis (run_sapg(mesh=)).  space_mesh: a ('space',)
    DeviceMesh — the SAPG phase row-splits the image over it
    (run_sapg_spatial; one chain, plain PyTorch).  Every rank of the mesh
    calls run_demo alike."""
    if solver not in ("salsa", "fista"):
        raise ValueError(f"solver must be 'salsa' or 'fista', got {solver!r}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    problem = build_problem(image, cfg, gen, dtype=dtype, device=device, noise=obs_noise)

    t0 = time.perf_counter()
    if space_mesh is not None:
        from semiblind_tv_tpu_torch.parallel.spatial import run_sapg_spatial

        sapg = run_sapg_spatial(problem, space_mesh, gen, noise=noise,
                                checkpoint_every=checkpoint_every,
                                checkpoint_path=checkpoint_path)
    else:
        sapg = run_sapg(problem, gen, n_chains=n_chains, noise=noise,
                        route="plain" if plain else None, mesh=mesh,
                        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path)
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
    if solver == "fista":
        salsa = fista_tv(
            problem.y,
            H_EB,
            tau=theta_EB * sigma2_EB,
            blur=problem.blur,
            tv_iters=cfg.salsa.tv_iters,
            max_iter=cfg.salsa.outer_iters,
            tol=cfg.salsa.tol,
            x_true=problem.x_true,
            prox_route="plain" if plain else None,
        )
        salsa.op_counts = {"A": 2 * salsa.n_iters, "AT": salsa.n_iters}
    else:
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
        "mesh": None if mesh is None else "x".join(str(v) for v in mesh.mesh.shape),
        "space_mesh": None if space_mesh is None else space_mesh.size(),
    }
    return results, sapg, salsa, problem


def _matplotlib():
    """matplotlib with the Agg backend; a clear error where it is absent."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("--plots needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_plots(out_dir, results, sapg, salsa, problem):
    """Reproduce the reference figure set (run_Gaussian_demo.m:248-301):
    trace_<name>.png for σ², θ, the PSF parameters, logπ and the PSF error,
    img_<name>.png for x, y, the MAP image and, with posterior moments, the
    posterior mean and standard deviation of chain 0."""
    plt = _matplotlib()
    os.makedirs(out_dir, exist_ok=True)

    def trace_fig(name, trace, true_val=None, ylabel=None):
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(trace, "b", lw=1.2, label=f"${name}_n$")
        if true_val is not None:
            ax.axhline(true_val, color="r", ls="--", label=f"${name}" + r"_{true}$")
        ax.set_xlabel("Iteration (n)")
        ax.set_ylabel(ylabel or name)
        ax.grid(True)
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"trace_{name}.png"), dpi=120)
        plt.close(fig)

    trace_fig("sigma2", sapg.sigma2s, results["sigma2_true"])
    trace_fig("theta", sapg.thetas)
    for pname, tr in sapg.psf_param_traces.items():
        trace_fig(pname, tr, results["true_psf_params"].get(pname))
    trace_fig("logPi", sapg.logPiTrace)
    trace_fig("err_psf", sapg.err_psf)

    panels = [
        ("x", problem.x_true.cpu().numpy()),
        ("y", problem.y.cpu().numpy()),
        ("xMAP", salsa.x),
    ]
    if sapg.posterior_mean is not None:
        # the reference's commented-out figmean panel (run_Gaussian_demo.m:291-295)
        panels.append(("posterior_mean", sapg.posterior_mean[0]))
        panels.append(("posterior_std", np.sqrt(sapg.posterior_var[0])))
    for title, img in panels:
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(img, cmap="gray")
        ax.set_axis_off()
        ax.set_title(title)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"img_{title}.png"), dpi=120)
        plt.close(fig)


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
    p.add_argument("--out", default=None, help="directory for results.json and traces.npz")
    p.add_argument("--plots", action="store_true",
                   help="also write the reference's trace and image figures to --out "
                        "(needs matplotlib)")
    p.add_argument("--solver", choices=["salsa", "fista"], default="salsa",
                   help="MAP solver: salsa (demos) or fista (legacy my_deblur_fista)")
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
    p.add_argument("--mesh", default=None, metavar="DxC",
                   help="run the SAPG phase sharded on a data x chains mesh, e.g. --mesh 1x4 "
                        "(--chains a multiple of C, else C)")
    p.add_argument("--space-mesh", type=int, default=None, metavar="S",
                   help="row-split the image over a ('space',) mesh of S ranks for the SAPG "
                        "phase (run_sapg_spatial; forces fft_mode=dft, one chain)")
    args = p.parse_args(argv)
    if args.mesh is not None and args.space_mesh:
        p.error("--mesh and --space-mesh exclude each other")
    mesh_shape = None
    if args.mesh is not None:
        mesh_shape = tuple(int(v) for v in args.mesh.lower().split("x"))
    ranks = args.space_mesh or (mesh_shape[0] * mesh_shape[1] if mesh_shape else 1)
    if ranks > 1 and torch.device(args.device).type == "cpu" and not _in_world():
        # the mesh's gloo processes, started here; rank 0 returns the results
        from semiblind_tv_tpu_torch.runtime.distributed import spawn

        return spawn(_demo_rank, ranks, (list(argv) if argv is not None else sys.argv[1:],))[0]
    if args.plots:
        if args.out is None:
            p.error("--plots writes its figures to --out DIR")
        _matplotlib()  # fail before the run, not after it

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
    if args.space_mesh:
        # the spatial estimator's transforms are the matmul DFTs
        sapg_over["fft_mode"] = "dft"
    if sapg_over:
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg_over))

    # full-precision fp32 matmuls and convolutions (no TF32) — the
    # counterpart of the JAX package's Precision.HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    dtype = torch.float64 if args.f64 else torch.float32
    own_world = not _in_world()   # a one-process world the mesh below makes
    mesh = space_mesh = None
    if mesh_shape is not None:
        from semiblind_tv_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(*mesh_shape, device_type=torch.device(args.device).type)
        if args.chains % mesh_shape[1] != 0:
            args.chains = mesh_shape[1]   # one chain a chains-rank by default
    if args.space_mesh:
        from semiblind_tv_tpu_torch.parallel.mesh import make_spatial_mesh

        space_mesh = make_spatial_mesh(args.space_mesh, device_type=torch.device(args.device).type)
    image = load_image(args.image, args.image_dir, size=args.size)
    results, sapg, salsa, problem = run_demo(
        cfg, image, n_chains=args.chains, dtype=dtype, device=args.device, solver=args.solver,
        mesh=mesh, space_mesh=space_mesh,
    )
    if own_world and _in_world():
        dist.destroy_process_group()
    if _in_world() and dist.get_rank() != 0:
        return results
    print(json.dumps(results, indent=2))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
        save_results(os.path.join(args.out, "traces.npz"), sapg, salsa)
        if args.plots:
            save_plots(args.out, results, sapg, salsa, problem)
    return results


def _in_world() -> bool:
    return dist.is_available() and dist.is_initialized()


def _demo_rank(rank, argv):
    """One rank of a CPU mesh the CLI started: the same main, in the world."""
    return main(argv)


if __name__ == "__main__":
    main()
