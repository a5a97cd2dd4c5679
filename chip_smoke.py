#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases:
  0. the card (nvidia-smi name and power limit), torch/CUDA versions; TF32
     off for matmuls and convolutions (the port's counterpart of the JAX
     package's Precision.HIGHEST).  Exits non-zero without a CUDA card.
  1. builds the kernels of semiblind_tv_tpu_torch/csrc/tv_kernels.cu.
  2. kernel against plain PyTorch version, same inputs, at 512² (B=1, 16)
     and a ragged shape (B=3, 480×352): kernel A fresh form at tol=0 (25
     sweeps) and tol=1e-3, kernel A warm form from non-zero duals (10
     sweeps, duals returned), kernel B (25 sweeps).  Bounds: max|Δ| ≤ 1e-5
     of the largest magnitude at tol=0, equal sweep counts at tol=1e-3.
     Times: median of 20 CUDA-event timings after warm-up.
  3. the port's main path, `run_demo` with the published Gaussian preset
     (w pinned), wheel.png 512², one chain, 2000 samples after 1500 warm-up
     steps, SALSA to 500 outer iterations; asserts both kernels' launch
     counters rose, finite results, θ_EB and σ²_EB in their boxes and
     mse_db < mse_db_observation.  Then the same pipeline at 64² on the card
     and on the CPU (plain versions) with the same injected noise, held to
     agree.
  4. SAPG step rate (chain-iter/s) at 512², B=1 and B=16, kernel and plain
     spatial segment; a 330-iteration SALSA solve (outer tol 0) at 512².

Prints the card line, a JSON line of the kernels, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises (exit code != 0).
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REL_BOUND = 1e-5


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps=20, warm=3):
    """Median milliseconds of fn() over `reps` CUDA-event timings."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase2(torch, dev, tv_cuda, fused_step_cuda, wheel, tag):
    """Kernel vs plain at the main path's shapes; returns per-kernel stats."""
    g0 = torch.Generator(device=dev)
    g0.manual_seed(0)
    stats = {k: dict(max_abs_err=0.0, ms=None, plain_ms=None) for k in ("A1", "A2", "B")}
    shapes = [(1, 512, 512), (16, 512, 512), (3, 480, 352)]
    for B, M, N in shapes:
        img = wheel[:M, :N]
        noise = lambda s=1.0: torch.randn((B, M, N), generator=g0, device=dev) * s
        # chains from the image (scale 1) down to nearly flat ones (1e-10),
        # so the early exit fires at different sweeps
        scales = torch.logspace(0, -10, B, device=dev) if B > 1 else torch.ones(1, device=dev)
        scales = scales[:, None, None]
        g = ((img[None] + 5.0 * noise()) * scales).contiguous()
        lam_sapg = torch.tensor(0.02, device=dev)     # λθ at the SAPG operating point
        lam_salsa = torch.tensor(100.0, device=dev)   # SALSA's τ/µ = 10 σ²
        px0, py0 = (noise(0.1) * scales).contiguous(), (noise(0.1) * scales).contiguous()

        # A2: fresh form
        kf, kst = tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, tol=0.0, return_state=False)
        pf, pst = tv_cuda.chambolle_prox_plain(g, lam_sapg, 25, tol=0.0, return_state=False)
        e_a2 = rel(kf, pf)
        stats["A2"]["max_abs_err"] = max(stats["A2"]["max_abs_err"], float((kf - pf).abs().max()))
        kf1, kst1 = tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, tol=1e-3, return_state=False)
        pf1, pst1 = tv_cuda.chambolle_prox_plain(g, lam_sapg, 25, tol=1e-3, return_state=False)
        it_k, it_p = kst1.iters.tolist(), pst1.iters.tolist()
        # A1: warm form
        wf, wst = tv_cuda.chambolle_prox_cuda(g, lam_salsa, 10, tol=0.0, duals=(px0, py0))
        qf, qst = tv_cuda.chambolle_prox_plain(g, lam_salsa, 10, tol=0.0, duals=(px0, py0))
        e_a1 = max(rel(wf, qf), rel(wst.px, qst.px), rel(wst.py, qst.py))
        stats["A1"]["max_abs_err"] = max(
            stats["A1"]["max_abs_err"],
            *(float((a - b).abs().max()) for a, b in ((wf, qf), (wst.px, qst.px), (wst.py, qst.py))),
        )
        wf1, wst1 = tv_cuda.chambolle_prox_cuda(g, lam_salsa, 10, duals=(px0, py0))
        qf1, qst1 = tv_cuda.chambolle_prox_plain(g, lam_salsa, 10, duals=(px0, py0))
        wit_k, wit_p = wst1.iters.tolist(), qst1.iters.tolist()
        # B: fused MYULA step
        x = (img[None] + noise(5.0)).abs().contiguous()
        prox = (x + noise(0.1)).contiguous()
        grad = noise(0.01).contiguous()
        z = noise().contiguous()
        sc = (torch.tensor(1.9, device=dev), torch.tensor(2.0, device=dev), lam_sapg)
        kb = fused_step_cuda.myula_prox_tv(x, prox, grad, z, *sc, 25, tol=0.0)
        pb = fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *sc, 25, tol=0.0)
        e_b = [rel(a, b) for a, b in zip(kb, pb)]
        stats["B"]["max_abs_err"] = max(
            stats["B"]["max_abs_err"], *(float((a - b).abs().max()) for a, b in zip(kb[:2], pb[:2]))
        )
        torch.cuda.synchronize()
        print(f"phase2 B={B} {M}x{N}: A2 tol=0 rel {e_a2:.3e}; A2 tol=1e-3 iters kernel {it_k} "
              f"plain {it_p}; A1 warm tol=0 rel {e_a1:.3e}; A1 tol=1e-3 iters kernel {wit_k} "
              f"plain {wit_p}; B rel xn {e_b[0]:.3e} proxn {e_b[1]:.3e} tv {e_b[2]:.3e} "
              f"(bound {REL_BOUND:g})", flush=True)
        check(e_a2 <= REL_BOUND, f"A2 disagrees: {e_a2}")
        check(e_a1 <= REL_BOUND, f"A1 disagrees: {e_a1}")
        check(max(e_b) <= REL_BOUND, f"B disagrees: {e_b}")
        check(kst.iters.tolist() == pst.iters.tolist() == [25] * B, "tol=0 must run 25 sweeps")
        check(it_k == it_p, f"A2 sweep counts differ: {it_k} vs {it_p}")
        check(wit_k == wit_p, f"A1 sweep counts differ: {wit_k} vs {wit_p}")

        times = {
            "A2": (lambda: tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, return_state=False),
                   lambda: tv_cuda.chambolle_prox_plain(g, lam_sapg, 25, return_state=False)),
            "A1": (lambda: tv_cuda.chambolle_prox_cuda(g, lam_salsa, 10, duals=(px0, py0)),
                   lambda: tv_cuda.chambolle_prox_plain(g, lam_salsa, 10, duals=(px0, py0))),
            "B": (lambda: fused_step_cuda.myula_prox_tv(x, prox, grad, z, *sc, 25),
                  lambda: fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *sc, 25)),
        }
        for k, (fk, fp) in times.items():
            mk, mp = cuda_ms(fk), cuda_ms(fp)
            print(f"phase2 time {k} B={B} {M}x{N}: kernel {mk * 1e3:.1f} us, plain "
                  f"{mp * 1e3:.1f} us per call [{tag}]", flush=True)
            if (B, M, N) == (1, 512, 512):
                stats[k]["ms"], stats[k]["plain_ms"] = mk, mp
    return stats


def step_rate(torch, problem, B, spatial_fn, n_steps=200, warm=20):
    from semiblind_tv_tpu_torch.sapg.estimator import generator_noise, make_sapg_step

    dev = problem.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    noise = generator_noise(gen, problem.blur.dtype, dev)
    step, aux = make_sapg_step(problem, B, spatial_fn=spatial_fn)
    shape = (B,) + problem.blur.shape
    X = problem.y.expand(shape).contiguous()
    prox = aux["prox_b"](X, aux["lam"] * aux["theta0"])[0]
    carry = (X, problem.blur.rfft(X), prox, aux["theta0"], problem.sigma2_init,
             dict(aux["params0"]))
    for ii in range(2, 2 + warm):
        carry, _ = step(carry, ii, noise(shape))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ii in range(2 + warm, 2 + warm + n_steps):
        carry, _ = step(carry, ii, noise(shape))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(carry[0]).all()), "non-finite chain state in the rate run")
    return n_steps * B / dt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1
    import numpy as np

    from semiblind_tv_tpu_torch import _build
    from semiblind_tv_tpu_torch.cli.run_demo import run_demo
    from semiblind_tv_tpu_torch.ops import fused_step_cuda, tv_cuda
    from semiblind_tv_tpu_torch.runtime.config import gaussian_preset
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv
    from semiblind_tv_tpu_torch.utils.images import load_image

    # ---- phase 0 ------------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tag = f"{card}"
    print(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {kind} x{torch.cuda.device_count()}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul_precision={torch.get_float32_matmul_precision()}", flush=True)

    # ---- phase 1 ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    built = (f"nvcc {_build.BUILD_SECONDS:.2f} s" if _build.BUILD_SECONDS is not None
             else "cached library")
    print(f"phase1 kernels built from {os.path.relpath(_build.SOURCE, HERE)}: {built}, "
          f"load {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- phase 2 ------------------------------------------------------------
    wheel_np = load_image(os.path.join(HERE, "data", "images", "wheel.png"))
    wheel = torch.from_numpy(wheel_np.astype(np.float32)).to(dev)
    stats = phase2(torch, dev, tv_cuda, fused_step_cuda, wheel, tag)

    # ---- phase 3 ------------------------------------------------------------
    cfg = gaussian_preset()
    cfg = dataclasses.replace(
        cfg, sapg=dataclasses.replace(cfg.sapg, samples=2000, warmup=1500, burn_in=1600)
    )
    tv_cuda.LAUNCHES = tv_cuda.FRESH_LAUNCHES = 0
    fused_step_cuda.LAUNCHES = 0
    results, sapg, salsa, problem = run_demo(cfg, wheel_np, n_chains=1, device="cuda")
    launches = {"A1": tv_cuda.LAUNCHES - tv_cuda.FRESH_LAUNCHES,
                "A2": tv_cuda.FRESH_LAUNCHES, "B": fused_step_cuda.LAUNCHES}
    print("phase3 results " + json.dumps(results), flush=True)
    print(f"phase3 launches {json.dumps(launches)}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    scalars = [results[k] for k in ("theta_EB", "sigma2_EB", "mse_db", "ssim", "snr_db",
                                    "psnr_db")]
    check(all(np.isfinite(scalars)), f"non-finite results {scalars}")
    check(np.all(np.isfinite(sapg.thetas)) and np.all(np.isfinite(salsa.x)), "non-finite traces")
    lo, hi = cfg.theta.box
    check(lo <= results["theta_EB"] <= hi, "theta_EB outside its box")
    s_lo, s_hi = (float(v) for v in problem.sigma2_box)
    check(s_lo <= results["sigma2_EB"] <= s_hi, "sigma2_EB outside its box")
    check(results["mse_db"] < results["mse_db_observation"], "MAP no better than y")
    check(salsa.x.shape == (512, 512), "wrong MAP shape")

    # the same pipeline at 64² on the card (kernels) and on the CPU (plain
    # versions), same injected noise: they must agree
    small = dataclasses.replace(
        gaussian_preset(fix_w1=False, fix_w2=False),
        sapg=dataclasses.replace(cfg.sapg, samples=60, warmup=30, burn_in=48),
        salsa=dataclasses.replace(cfg.salsa, outer_iters=60),
    )
    rng = np.random.default_rng(5)
    img64 = wheel_np[224:288, 224:288]
    obs = rng.standard_normal(img64.shape)
    draws = rng.standard_normal((29 + 59, 1) + img64.shape).astype(np.float32)

    def injected(device):
        it = iter(draws)
        return lambda shape: torch.from_numpy(next(it)).to(device)

    r_card, *_ = run_demo(small, img64, device="cuda", obs_noise=obs, noise=injected(dev))
    r_cpu, *_ = run_demo(small, img64, device="cpu", obs_noise=obs, noise=injected("cpu"))
    agree = {k: abs(r_card[k] - r_cpu[k]) / abs(r_cpu[k])
             for k in ("theta_EB", "sigma2_EB", "mse_db", "ssim")}
    # SSIM runs in float32 with L=1 on [0, 255] data (MATLAB's convention):
    # its variances E[x²]−µ² cancel to ~4e-3 absolute against c2 = 9e-4, so
    # the convolution's summation order alone moves it by ~1e-3 relative
    bounds = {"theta_EB": 1e-3, "sigma2_EB": 1e-3, "mse_db": 1e-3, "ssim": 1e-2}
    print(f"phase3 64x64 card vs cpu relative differences {json.dumps(agree)} "
          f"(bounds {json.dumps(bounds)})", flush=True)
    for k, b in bounds.items():
        check(agree[k] <= b, f"card and CPU runs disagree at 64x64 on {k}")

    # ---- phase 4 ------------------------------------------------------------
    free = gaussian_preset(fix_w1=False, fix_w2=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prob = build_problem(wheel_np, free, gen, device=dev)
    for B in (1, 16):
        rk = step_rate(torch, prob, B, None)
        rp = step_rate(torch, prob, B, fused_step_cuda.myula_prox_tv_plain)
        print(f"phase4 SAPG step 512x512 B={B}: kernel {rk:.1f} chain-iter/s, plain "
              f"{rp:.1f} chain-iter/s [{tag}]", flush=True)
    theta, sig2 = 0.05, float(prob.sigma_true) ** 2
    kw = dict(tau=theta * sig2, mu=theta * 0.1, blur=prob.blur, tol=0.0)
    salsa_tv(prob.y, prob.H_true, max_iter=10, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = salsa_tv(prob.y, prob.H_true, max_iter=330, **kw)
    dt = time.perf_counter() - t0
    check(res.n_iters == 330 and np.all(np.isfinite(res.x)), "SALSA 330 run failed")
    print(f"phase4 SALSA 512x512 330 outer iterations (tol 0): {dt:.3f} s [{tag}]", flush=True)

    src = os.path.relpath(_build.SOURCE, HERE)
    rows = [
        ("chambolle_prox_cuda[warm]", "semiblind_tv_tpu/ops/tv_pallas.py:262", "A1"),
        ("chambolle_prox_cuda[fresh]", "semiblind_tv_tpu/ops/tv_pallas.py:232", "A2"),
        ("myula_prox_tv", "semiblind_tv_tpu/ops/fused_step_pallas.py:375", "B"),
    ]
    kernels = [
        dict(name=n, route="cuda", source=src, replaces=r, launches=launches[k],
             max_abs_err=stats[k]["max_abs_err"], ms=stats[k]["ms"],
             plain_ms=stats[k]["plain_ms"])
        for n, r, k in rows
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
