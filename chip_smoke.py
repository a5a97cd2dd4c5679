#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase10     # phases 0, 1 and 10 only
    python3 chip_smoke.py --phase11     # phases 0, 1 and 11 only

Phases:
  0. the card (nvidia-smi name and power limit), torch/CUDA versions; TF32
     off for matmuls and convolutions (the port's counterpart of the JAX
     package's Precision.HIGHEST).  Exits non-zero without a CUDA card.
  1. builds the kernel library from every source under
     semiblind_tv_tpu_torch/csrc/ (one nvcc per source, in parallel).
  2. kernel against plain PyTorch version, same inputs, at 512² (B=1, 16),
     a ragged shape (B=3, 480×352) and 256² B=40 (two groups of chains, three
     a block: the stacked form, as at 512² B=16):
     kernel A fresh form at tol=0 (25 sweeps) and tol=1e-3, kernel A warm
     form from non-zero duals (10 sweeps, duals returned), kernel B (25
     sweeps).  Bounds: bit-equal fields at tol=0 (max|Δ| = 0), B's TV and
     A2's last residual within REL_BOUND (another order of summation),
     equal sweep counts at tol=1e-3 (chains stopping at sweep 1 and 25
     among them), barrier error code 0; each shape's resident geometry.
     Times: median of 20 CUDA-event timings after warm-up, and the device
     time (torch.profiler).  Then the resident kernel's design: ptxas's
     registers and spills (none allowed), blocks an SM held to its
     __launch_bounds__, its exact root against sqrtf on every non-negative
     float and its exact quotient against '/' on 2^25·3 pairs and every
     pair of special values, the barrier's cost a sweep (A2's device time at 512² B=1 for 1
     and 25 sweeps), and a profiler listing of one call of A1, A2, B, C and
     J's base (one launch each).
  3. the port's main path, `run_demo` with the published Gaussian preset
     (w pinned), wheel.png 512², one chain, 2000 samples after 1500 warm-up
     steps, SALSA to 500 outer iterations; asserts both kernels' launch
     counters rose, finite results, θ_EB and σ²_EB in their boxes and
     mse_db < mse_db_observation.  Then the same pipeline at 64² on the card
     and on the CPU (plain versions) with the same injected noise, held to
     agree.
  4. SAPG step rate (chain-iter/s) at 512², B=1 and B=16, kernel and plain
     spatial segment; a 330-iteration SALSA solve (outer tol 0) at 512².
  5. the large-image path through the blocked kernels (csrc/tv_blocked.cu):
     a. blocked kernel against plain at 1024² (B=1, 4), 2048² (B=1, 2) and
        a ragged 1000×1528 (B=3): fresh prox at tol=0 (25 sweeps) and
        tol=1e-3, warm prox from non-zero duals (10 sweeps, duals
        returned) at tol=0 and tol=1e-3, fused step (25 sweeps) at σ²=1
        and σ²≠1; max|Δ| ≤ 1e-5 of the largest magnitude at tol=0, equal
        sweep counts at tol=1e-3, a chain exiting inside a pass (the redo)
        at 2048² and at 1000×1528.  The resident kernel (A2, A1, B; the
        walk form at these sizes) on the same inputs: bit-equal fields at
        tol=0, equal sweep counts at tol=1e-3, barrier error code 0.  Times
        of the blocked kernel, its plain version and the resident kernel on
        the same inputs.
     b. `run_demo` at 2048² synthetic — Gaussian with w free and the
        σ²-log-scale option, Laplace, Moffat — and at 1024² synthetic with
        the published Gaussian preset (w pinned), 1000 samples after 700
        warm-up, SALSA to 500: the blocked counters rose and kernel A's and
        B's did not, results finite and in their boxes, mse_db below y's.
     c. the 1024² pipeline (60 SAPG steps, 60 SALSA iterations) through the
        blocked kernels and through their plain versions on the card, same
        injected noise: θ_EB, σ²_EB and mse_db agree to 1e-3 relative.
     d. SAPG chain-iter/s at 1024² B=4 and 2048² B=1, 2 (blocked, kernel
        B, plain) and at 2048² B=1 with w pinned (blocked); SALSA at 2048²,
        100 outer iterations (tol 0).
     e. the pass kernel's design: ptxas's registers and spills of
        blocked_pass (none allowed), its active blocks per SM (held to its
        __launch_bounds__), the halo factor and pass split of 25 and 10
        sweeps; its fast quotient and root against the IEEE operators
        (every float of the root's range, 2^28 sampled quotients: bit-equal
        required); the device time of one pass of 1 and of 7 sweeps at
        2048² B=1 on the same tiles (the cost of a sweep and the fixed cost
        of a pass: window load and store, reduce);
        and the blocked prox beside A2 at 512² B=16 on the same inputs.
  6. the dense-DFT steps and the in-kernel noise (csrc/dft_kernels.cu,
     csrc/rng.cuh):
     a. kernel C at 512² (B=1, 16) and 481×353 (B=3), I's seeds form at
        2048² (B=1, 2) and 1000×1528 (B=3), against their plain versions
        with the same seeds (bound as phase 2), timed beside B and I fed the
        same noise as a field; C's raw noise field (x = prox = grad = 0,
        γ = 0.5) within the moment bands of tests/test_tpu_only.py.  Kernels
        D and E at 256² (B=1, 2), 512² (B=1, 16) and 480×353 (B=3, one chain
        stopping inside the run) at tol=0: within 1e-5 of the float32 plain
        version and at most 2× its deviation from a float64 plain version;
        at tol=1e-3 sweep counts within one.  D's and E's products alone
        through the 3×TF32 wgmma GEMM (`fused_dft_cuda.dft_products`) at
        the same shapes: within 1e-5 of torch.matmul in float32 and at most
        2× its deviation from float64 (the ratios printed).  Times of D, E,
        their plain versions, route B with cuFFT and with the matmul DFT
        transforms, and of the products through the GEMM beside torch.matmul
        (cuBLAS fp32, TF32 off); at 256² B=1 the host µs of a D, E,
        products and B+cuFFT call, split into the wrapper's Python and its
        C call, and the C side's unit cost of a tensor-map encoding and of
        an attribute set.  The library's SASS holds the GEMM's HGMMA TF32
        instructions (cuobjdump).
     b. `run_demo` (1000/700 samples): 512² published Gaussian in dft mode
        with fuse_dft (D) and with fuse_irdft (E; B runs the warm-up),
        512² with in_kernel_rng (C), 256² B=2 in dft mode (the auto rule
        picks D), 2048² synthetic Gaussian w free with σ²-log-scale and
        in_kernel_rng (I's seeds form): counters rose, results in their
        boxes, mse_db below y's.
     c. the 512² kernel-D pipeline (60 SAPG + 60 SALSA) through the kernels
        and through the plain versions on the card: agree to 1e-3.
     d. SAPG chain-iter/s, w free: 512² B=1, 16 (fft+B, dft+B, D, E, C),
        256² B=1, 2 (fft+B, D), 2048² B=1 (I, I with seeds).
  7. kernel J, the Chambolle-sweep variant probe (csrc/prox_variants.cu, one
     resident launch a call on csrc/resident.cuh):
     a. ptxas's report and the occupancy of every mode's two forms; every one
        of the eleven modes against its plain version at 512² (B=1, 16) and
        480×352 (B=3, chain 0 stopping earlier), and base and while at
        640×1152 B=1 (the walk form): bit-equal f (max|Δ| = 0) at tol=0 and
        J's λ and at a decisive tol (λ = 20), equal sweep counts; a barrier
        error code 0 (one launch a call: phase 2's listing).  Base's time at
        512² B=16.
     b. J's own run (the probe's main path) and the resident design's
        anatomy: every mode at 512² B=16 and B=1, 25 sweeps, 100 chained
        steps (CUDA events) and its device µs a call (CUDA events queued
        behind a spin kernel: `gated_us`, no profiler), one JSON line each;
        the production A2 kernel on the same inputs, whose f base's must
        equal to the bit; noresid's and while's device µs at 1 and 25
        sweeps, tol 0 (a group-sweep's cost without and with the residual).
  8. the run surface (files under the git-ignored build/phase8/):
     a. resume: the 512² Gaussian w-free demo (phase 5's 1000/700) run
        uninterrupted; the same SAPG run with checkpoint_every=300 cut by a
        preemption before segment 2; `run_demo` on that checkpoint resumes:
        kernel B launched once for each main step left and never for the
        warm-up, A2 not at all, and θ, σ², the PSF traces and X_last within
        1e-6 relative of the uninterrupted run (the printed difference).
     b. the NaN guard: a NaN put into X[0, 0, 0] before segment 2 restores
        from the checkpoint and ends within 1e-6 of the clean run; without a
        checkpoint the run raises SAPGDivergenceError; the resident kernel's
        barrier error code stays 0 on the NaN chain.
     c. resume through kernel D: 256² B=1, fft_mode='dft', 300/200 samples,
        the same bound; D's launches counted.
     d. posterior moments at 512² B=16 (200 steps after burn-in): finite,
        var ≥ 0; the step rate without and with them, interleaved.
     e. the isotropic family's 512² demo (1000/700): θ and w in their
        boxes, mse_db below y's.
     f. TV-FISTA at 512² (H_true, 100 iterations, tol 0) through A2, its
        time and launches (100); at 64² (100 iterations) A2 against the
        plain prox on the card within 1e-5 relative in x, and the card's
        float64 solve against the CPU's within 1e-9 (the float32 card-vs-CPU
        difference, which rounding amplified over the accelerated
        iterations sets, is printed beside the CPU's own float32 error).
     g. the power iteration at 512² (float64, tol 1e-7) within 1e-3 of
        max |H|².
     h. `runtime.profiling.trace` around 5 steps at 512² B=1: the exported
        Chrome trace names resident_step.

  9. the solver zoo and the wavelet path, 512² wheel with the published
     Gaussian OTF at BSNR 30 (`build_problem`); each path driven with the
     launch counters set to 0 just before it and read just after:
     a. `csalsa_tv`, 200 outer iterations at the reference's ε (σ from the
        problem, µ1 0.05, µ2 10): A1 launched once an iteration, x finite,
        ‖Ax − y‖ ≤ ε·(1 + 1e-3), mse_db below y's.
     b. `coral_tv_l1` cold (A2) and warm (A1), 200 iterations each: the
        last objective at most the first iteration's, mse_db below y's.
        At 64² (60 iterations, chambolle_tol 0) 9a's and 9b's kernel
        routes against `prox_route='plain'` on the card: max|Δx| ≤ 1e-6
        relative (0 expected, `--fmad=false`).
     c. `csalsa_tv` at 1024² (synthetic phantom), 50 iterations: the
        blocked prox (F) launched 50 times, A1 never.
     d. generic `salsa` (the blur as caller operators, a warm TV prox on
        A1), `nesta` (TV, 5 continuation legs) and `spgl1_bpdn`: finite,
        below y's mse_db, each time printed.
     e. `cli.run_wavelet_l1` with the reference's defaults (L 4, Haar, blur
        9, BSNR 30, 3000 samples): θ_EB in [1e-3, 1], mse_db below y's,
        the SAPG and SALSA times.
     f. `cli.oracle_sweep` with --no-sapg over 5 θ (SALSA through A1), and
        with a 300/200 SAPG leg (A2's initial prox, B a step): the MSE-best
        θ and its mse_db.
     g. `circ_conv`/`circ_corr` against BlurOperator apply/adjoint (7×7,
        512²) within 1e-5 relative, timed beside the rfft path.
     Prints `phase9 took … s`.
 10. the parallel path (parallel/, cli/run_sharded.py), 512² wheel, BSNR 30,
     Gaussian with w free, 200/100 samples; each path driven with the launch
     counters set to 0 just before it and read just after:
     a. a one-process NCCL world and a 1x1 ('data', 'chains') mesh:
        run_sapg(mesh=, n_chains=4) against run_sapg(n_chains=4) on the same
        generator (bit-equal, or within 1e-6 relative: printed which); A2
        once, B once a step.
     b. `run_sharded --problems 4 --chains-per-shard 4` in that world: one B
        launch of 16 chains a step (γ, λ, λθ one value a chain), each
        problem's θ_EB/σ²_EB/PSF in their boxes and mse_db below y's; each
        problem of run_sapg_sharded against its own single-problem run on
        the same noise (traces 1e-6, X_last 1e-5 relative; bit-equality
        printed); the 16-chain launch's chain-iter/s beside 4 single-problem
        runs'.  Kernels B, A2 and A1 at 512² B=16 with (B,) scalars against
        their plain versions fed the same vectors: bit-equal (tol 0).
     c. two processes on the one card over gloo (2 of 4 chains each): θ and
        σ² after 100 steps within 1e-5 of 10a's one rank.
     d. run_sapg_spatial (60/30, dft) and spatial_salsa_tv (60 iterations)
        in a one-rank ('space',) world against run_sapg and salsa_tv on the
        plain route: within 1e-5 relative.
     e. `benchmarks/run_reference_images` over wheel and boat at 64/32
        samples, aggregated by run_stats.
     f. the data axis in dft mode: 2 problems × 1 chain at 256² (fuse_dft
        auto, in_kernel_rng on), 30/10 samples: kernel D launched every
        step (the rule reads one problem's chains), kernel C never (no
        seeds drawn); each problem against its own run within
        DFT_AXIS_BOUND (bit-equality printed: D's split-K plan follows the
        launch's chain count).
     Prints `phase10 took … s`.
 11. the SAPG step's residual, statistics and update (csrc/sapg_stats.cu,
     ops/sapg_stats.py) at 512² B=1 and B=16 with the PSF pinned, and at
     B=1 with two free PSF parameters: each kernel against its plain
     version on the card (the residual within 1e-6 of the largest
     magnitude; every statistic, G_σ and each G_p included, within 1e-5 of
     the float64 magnitude of its terms, ops/sapg_stats.stat_scales; the
     update within 1e-6: float32 in another order), each one's CUDA-event
     and device time with L2 emptied before each call (a 256 MB read: at
     B=16 X̂ and Ĝ would otherwise stay in the 50 MB L2 from call to call,
     which the step never sees) beside its plain version's and its bound;
     then the launches of
     a 512² B=1 Gaussian run_sapg of 40/20 samples (the residual and the
     statistics every iteration, logπ once more, the update every SAPG
     iteration).

Prints the card line, a JSON line of the kernels (each with its bound:
see PEAK_FP32 below; D and E also with their products' time and TF32
bound; A1's, A2's and B's launches add phases 9's and 10's to phase 3's,
A2's also phase 8f's, F's phase 9c's to phase 5's), and as the last line
{"ok": true, "device": {...}}.
Any failed check raises (exit code != 0).
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REL_BOUND = 1e-5
# readings of torch.profiler a measurement takes at most while the profiler
# records no kernel at all (see `profiled`)
PROFILE_TRIES = 4
KERNELS_SRC = "semiblind_tv_tpu_torch/csrc/tv_kernels.cu"
BLOCKED_SRC = "semiblind_tv_tpu_torch/csrc/tv_blocked.cu"
DFT_SRC = "semiblind_tv_tpu_torch/csrc/dft_kernels.cu"
# phase 5: the image sizes of the two rungs above 512² and the kernel shapes
TILED, STREAMED = 1024, 2048
KERNEL_SHAPES = [(1, TILED, TILED), (4, TILED, TILED), (1, STREAMED, STREAMED),
                 (2, STREAMED, STREAMED), (3, 1000, 1528)]
# the demos of phases 5, 6 and 8: half of phase 3's 2000/1500, to keep the
# whole run within its time
DEMO_BUDGET = dict(samples=1000, warmup=700, burn_in=800)
J_SRC = "semiblind_tv_tpu_torch/csrc/prox_variants.cu"
# The least time the card could take for a kernel's work (bound_ms): the
# larger of its float operations over the H100 SXM's non-tensor float32 peak
# and its bytes (each input read once, each output written once) over the
# HBM rate, at 700 W (NVIDIA's H100 SXM data sheet).  An add,
# subtract, multiply, divide or sqrt counts one operation (a divide or sqrt
# takes several instructions, so the bound stays a lower bound); selects,
# negations and C's integer Philox work are not counted.  Per pixel: a
# Chambolle sweep 26 (div p − g/λ and ∇u 6, |∇u| 4, residual 8, update 8),
# a prox 6 more (g/λ once, f = g − λ·div p), a MYULA step 16 more (the
# update 9, its circular TV 7); sweeps are those this run's data ran.
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# D's and E's products run in 3×TF32 on the tensor cores: their bound counts
# three passes of each product at the dense TF32 rate (same data sheet)
PEAK_TF32 = 495e12
SWEEP_FLOP, PROX_FLOP, STEP_FLOP = 26, 6, 16


def prox_work(B, M, N, sweeps, duals_io=False):
    """(operations, bytes) of a prox over B chains that ran `sweeps` sweeps
    in all: g in and f out, plus the duals in and out in the warm form."""
    return (M * N * (SWEEP_FLOP * sweeps + PROX_FLOP * B),
            4 * B * M * N * (6 if duals_io else 2))


def step_work(B, M, N, sweeps, seeds=False):
    """(operations, bytes) of a fused MYULA step: x, prox, grad and z (or
    the (B, 2) seeds) in, xn, proxn and tv out."""
    fields = 5 if seeds else 6
    return (M * N * (SWEEP_FLOP * sweeps + (PROX_FLOP + STEP_FLOP) * B),
            4 * B * M * N * fields + 4 * B + (8 * B if seeds else 0))


def dft_step_work(B, M, N, sweeps, forward):
    """(operations, bytes) of kernel D (forward=True) or E: the step plus the
    DFT products (2 flops a multiply-add), Ĝ and the factor matrices in,
    x̂ out (D)."""
    nh = N // 2 + 1
    flop, nbytes = step_work(B, M, N, sweeps)
    gemm = (16 if forward else 8) * M * M * nh + (8 if forward else 4) * M * N * nh
    mats = 4 * (2 * M * M + 2 * nh * N + (2 * N * nh if forward else 0))
    spectra = 8 * B * M * nh * (2 if forward else 1)
    return flop + B * gemm, nbytes + mats + spectra


def dft_products_work(B, M, N, forward):
    """(TF32 operations, bytes) of D's (forward=True) or E's products alone:
    three tensor-core passes of each product (2 flops a multiply-add); Ĝ
    and the factor matrices in, grad out, and for D x in and x̂ out."""
    nh = N // 2 + 1
    gemm = (16 if forward else 8) * M * M * nh + (8 if forward else 4) * M * N * nh
    mats = 4 * (2 * M * M + 2 * nh * N + (2 * N * nh if forward else 0))
    fields = (8 * B * M * nh + 4 * B * M * N) * (2 if forward else 1)
    return 3 * B * gemm, mats + fields


def bound(work, peak=PEAK_FP32, key="bound"):
    """{key}_ms and {key}_by of (operations, bytes) at `peak` operations/s."""
    t_ops, t_bytes = work[0] / peak, work[1] / HBM_BYTES_PER_S
    return {f"{key}_ms": max(t_ops, t_bytes) * 1e3,
            f"{key}_by": "operations" if t_ops >= t_bytes else "bytes"}


def profiled(torch, fn, calls):
    """torch.profiler's key_averages() of `calls` calls of fn (CUDA
    activity), after one warm-up call.  Now and then the profiler returns
    a session without a single kernel although the calls ran (a few in a
    thousand one-call sessions on an H100, idle time around the calls or
    not: semiblind_tv_tpu_torch/benchmarks/profiler_drops.py counts them),
    so a reading that holds no kernel is taken again, up to PROFILE_TRIES
    times; any reading that holds a kernel is returned as it is."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        if any(e.device_time_total > 0 for e in rows):
            return rows
    raise AssertionError(f"the profiler recorded no kernel in {PROFILE_TRIES} readings")


def products_profile(torch, fn, calls=5):
    """Device µs a call of each kernel that fn launches (torch.profiler)."""
    rows = [(e.key, e.device_time_total / calls) for e in profiled(torch, fn, calls)
            if e.device_time_total > 0]
    short = lambda k: k.replace("(anonymous namespace)::", "").split("(")[0]  # noqa: E731
    return ", ".join(f"{short(k)} {t:.1f}" for k, t in sorted(rows, key=lambda r: -r[1]))


def host_us(torch, lib, entries, reps=50, warm=3):
    """{name: (host µs of one fn() call, host µs of the kernel library's C
    entry within it)} for entries {name: (fn, C entry)}: medians over
    `reps` rounds that call each fn once in turn, each call started on an
    idle card so that no launch waits for a queue slot.  The difference is
    the wrapper's Python (checks, allocations, ctypes marshalling, and any
    PyTorch calls around the kernel); the C call is the launches and what
    the C side does around them."""
    orig = {entry: getattr(lib, entry) for _, entry in entries.values()}
    total = {name: [] for name in entries}
    c_times = {name: [] for name in entries}
    now = [None]   # the entry being timed

    def timer(c_fn):
        def timed(*args):
            t0 = time.perf_counter()
            out = c_fn(*args)
            c_times[now[0]].append(time.perf_counter() - t0)
            return out
        return timed

    for entry, c_fn in orig.items():
        setattr(lib, entry, timer(c_fn))
    try:
        for _ in range(warm + reps):
            for name, (fn, _) in entries.items():
                now[0] = name
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                total[name].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    finally:
        for entry, c_fn in orig.items():
            setattr(lib, entry, c_fn)
    out = {}
    for name in entries:
        check(len(c_times[name]) == warm + reps,
              f"{name}: its C entry ran {len(c_times[name])} times in {warm + reps} calls")
        out[name] = tuple(statistics.median(v[warm:]) * 1e6 for v in (total[name], c_times[name]))
    return out


def sass_hgmma_tf32(lib_path):
    """The library's HGMMA TF32 instructions (cuobjdump -sass)."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if "HGMMA" in ln and "TF32" in ln]


def gated_us(torch, fn, reps=20, warm=3, gate_cycles=2_000_000):
    """Median device µs of one fn() call, without the profiler: each call's
    two CUDA events are queued behind a ~1 ms spin kernel
    (torch.cuda._sleep), so the host has enqueued the events and the call
    before the card reaches them, and the events bracket the call's
    kernels alone, not its wrapper's host time."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(gate_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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
    """The largest per-chain relative deviation: max|a − b| over a chain's
    field over that chain's largest magnitude, so a chain of small values
    is held to its own scale ((B,) vectors: element by element)."""
    if a.ndim < 2:
        a, b = a.reshape(-1, 1), b.reshape(-1, 1)
    elif a.ndim == 2:
        a, b = a[None], b[None]
    d = (a - b).abs().flatten(1).amax(1)
    return float((d / b.abs().flatten(1).amax(1).clamp_min(1e-30)).max())


def max_abs(pairs):
    return max(float((a - b).abs().max()) for a, b in pairs)


def phase2(torch, dev, tv_cuda, fused_step_cuda, wheel, tag):
    """Kernel vs plain at the main path's shapes, and a multi-group batch;
    returns per-kernel stats."""
    g0 = torch.Generator(device=dev)
    g0.manual_seed(0)
    stats = {k: dict(max_abs_err=0.0, ms=None, plain_ms=None) for k in ("A1", "A2", "B")}
    shapes = [(1, 512, 512), (16, 512, 512), (3, 480, 352), (40, 256, 256)]
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
        geo = tv_cuda.resident_geometry(B, M, N, tv_cuda.resident_capacity(dev),
                                        tv_cuda.resident_stack(dev))

        # A2: fresh form
        kf, kst = tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, tol=0.0, return_state=False)
        pf, pst = tv_cuda.chambolle_prox_plain(g, lam_sapg, 25, tol=0.0, return_state=False)
        e_a2 = max_abs([(kf, pf)])
        stats["A2"]["max_abs_err"] = max(stats["A2"]["max_abs_err"], e_a2)
        kf1, kst1 = tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, tol=1e-3, return_state=False)
        pf1, pst1 = tv_cuda.chambolle_prox_plain(g, lam_sapg, 25, tol=1e-3, return_state=False)
        it_k, it_p = kst1.iters.tolist(), pst1.iters.tolist()
        e_res = rel(kst1.err, pst1.err)
        # A1: warm form
        wf, wst = tv_cuda.chambolle_prox_cuda(g, lam_salsa, 10, tol=0.0, duals=(px0, py0))
        qf, qst = tv_cuda.chambolle_prox_plain(g, lam_salsa, 10, tol=0.0, duals=(px0, py0))
        e_a1 = max_abs([(wf, qf), (wst.px, qst.px), (wst.py, qst.py)])
        stats["A1"]["max_abs_err"] = max(stats["A1"]["max_abs_err"], e_a1)
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
        e_b = max_abs(zip(kb[:2], pb[:2]))
        e_tv = rel(kb[2], pb[2])
        stats["B"]["max_abs_err"] = max(stats["B"]["max_abs_err"], e_b)
        code = tv_cuda.barrier_error()
        print(f"phase2 B={B} {M}x{N}: geometry tile {geo.tile}, {geo.tiles} tiles a chain, "
              f"{geo.chains} chains a group, {geo.stack} a block, {geo.groups} groups, grid "
              f"{geo.grid}; A2 tol=0 "
              f"max|Δf| {e_a2:g}; A2 tol=1e-3 iters kernel {it_k} plain {it_p}, last residual "
              f"rel {e_res:.3e}; A1 warm tol=0 max|Δ| f/px/py {e_a1:g}; A1 tol=1e-3 iters "
              f"kernel {wit_k} plain {wit_p}; B max|Δ| xn/proxn {e_b:g}, tv rel {e_tv:.3e} "
              f"(bound {REL_BOUND:g}); barrier error code {code}", flush=True)
        check(code == 0, f"a barrier gave up (code {code})")
        check(e_a2 == 0.0, f"A2 is not bit-equal to its plain version: {e_a2}")
        check(e_a1 == 0.0, f"A1 is not bit-equal to its plain version: {e_a1}")
        check(e_b == 0.0, f"B is not bit-equal to its plain version: {e_b}")
        check(max(e_tv, e_res) <= REL_BOUND, f"B's tv or A2's residual differ: {e_tv}, {e_res}")
        check(kst.iters.tolist() == pst.iters.tolist() == [25] * B, "tol=0 must run 25 sweeps")
        check(it_k == it_p, f"A2 sweep counts differ: {it_k} vs {it_p}")
        check(wit_k == wit_p, f"A1 sweep counts differ: {wit_k} vs {wit_p}")
        check(B < 3 or {1, 25} <= set(it_k), f"no chain stopped at sweep 1 and at 25: {it_k}")

        times = {
            "A2": (lambda: tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, return_state=False),
                   lambda: tv_cuda.chambolle_prox_plain(g, lam_sapg, 25, return_state=False)),
            "A1": (lambda: tv_cuda.chambolle_prox_cuda(g, lam_salsa, 10, duals=(px0, py0)),
                   lambda: tv_cuda.chambolle_prox_plain(g, lam_salsa, 10, duals=(px0, py0))),
            "B": (lambda: fused_step_cuda.myula_prox_tv(x, prox, grad, z, *sc, 25),
                  lambda: fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *sc, 25)),
        }
        for k, (fk, fp) in times.items():
            mk, mp, dk = cuda_ms(fk), cuda_ms(fp), device_us(torch, fk, "resident")
            print(f"phase2 time {k} B={B} {M}x{N}: kernel {mk * 1e3:.1f} us (device "
                  f"{dk:.1f} us), plain {mp * 1e3:.1f} us per call [{tag}]", flush=True)
            if (B, M, N) == (1, 512, 512):
                stats[k]["ms"], stats[k]["plain_ms"] = mk, mp
                stats[k]["device_us"] = dk
        if (B, M, N) == (1, 512, 512):   # the timed calls' work (tol=1e-3)
            b_sweeps = tv_cuda.chambolle_prox_cuda(kb[0], lam_sapg, 25, return_state=False)[1]
            stats["A2"]["work"] = prox_work(B, M, N, sum(it_k))
            stats["A1"]["work"] = prox_work(B, M, N, sum(wit_k), duals_io=True)
            stats["B"]["work"] = step_work(B, M, N, sum(b_sweeps.iters.tolist()))
    return stats


def resident_design(torch, dev, tv_cuda, fused_step_cuda, build, wheel, tag):
    """The resident kernel's registers, spills and occupancy; its exact root
    against sqrtf on every non-negative float and its exact quotient against
    '/' on a sample of pairs; the barrier's cost a sweep;
    one launch a call (a profiler listing of one call of A1, A2, B, C and
    kernel J, which runs on the same machinery)."""
    from semiblind_tv_tpu_torch.benchmarks import probe_prox_variants as pv

    occ = tv_cuda.resident_occupancy(dev)
    ptxas = build.kernel_usage("resident_")
    cap = tv_cuda.resident_capacity(dev)
    geo = tv_cuda.resident_geometry(16, 512, 512, cap, tv_cuda.resident_stack(dev))
    print(f"phase2 design resident: ptxas {ptxas}; runtime {occ}; capacity {cap} blocks; "
          f"512x512 B=16 grid {geo.grid}, {geo.stack} chains a block, {geo.groups} groups",
          flush=True)
    check(occ["blocks_per_sm"] == occ["launch_bounds_blocks"],
          f"resident: {occ['blocks_per_sm']} blocks an SM, the design counts on "
          f"{occ['launch_bounds_blocks']}")
    check(sorted(ptxas) == ["resident_prox", "resident_prox_stacked", "resident_prox_walk",
                            "resident_step", "resident_step_stacked", "resident_step_walk"]
          and all(v["spill_stores"] == v["spill_loads"] == 0 for v in ptxas.values()),
          f"resident spills: ptxas {ptxas}")
    check(geo.grid <= occ["blocks_per_sm"] * occ["sms"], "the 512² B=16 grid exceeds the card")

    # sqrt_rn_exact against sqrtf on every non-negative float, ∞ and NaN
    lib = build.load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def same_bits(got, want):
        return (got.view(torch.int32) == want.view(torch.int32)) | (
            torch.isnan(got) & torch.isnan(want))

    bad = 0
    for start in range(0, 0x7F800000 + 2, 1 << 27):
        x = torch.arange(start, min(start + (1 << 27), 0x7F800002), dtype=torch.int32,
                         device=dev).view(torch.float32)
        r = torch.empty_like(x)
        check(lib.sb_resident_exact_ops(x.data_ptr(), None, None, r.data_ptr(), x.numel(),
                                        stream) == 0, "sb_resident_exact_ops failed")
        bad += int((~same_bits(r, torch.sqrt(x))).sum())
    print(f"phase2 design sqrt_rn_exact differs from sqrtf on {bad} of {0x7F800002} floats "
          "(every non-negative float, +inf and a NaN)", flush=True)
    check(bad == 0, "sqrt_rn_exact is not sqrtf")

    # div_rn_exact against '/' on random pairs of floats (every exponent,
    # subnormals, both signs), on pairs whose quotient is subnormal, and on
    # every pair of special values
    gq = torch.Generator(device=dev)
    gq.manual_seed(23)
    n = 1 << 25

    def floats(hi):
        mag = torch.randint(0, hi, (n,), generator=gq, device=dev, dtype=torch.int32)
        sign = 1.0 - 2.0 * torch.randint(0, 2, (n,), generator=gq, device=dev)
        return mag.view(torch.float32) * sign

    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -3.0,
                             1e-45, 3e38, -5e-39], device=dev)
    pairs = [(floats(0x7F800000), floats(0x7F800000)),
             (floats(0x0C000000), torch.exp2(torch.rand(n, generator=gq, device=dev) * 31)),
             (floats(0x7F800000), torch.exp2(torch.rand(n, generator=gq, device=dev) * 31)),
             (specials.repeat_interleave(10), specials.repeat(10))]
    bad = total = 0
    for a, b in pairs:
        q, r = torch.empty_like(a), torch.empty_like(a)
        check(lib.sb_resident_exact_ops(a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(),
                                        a.numel(), stream) == 0, "sb_resident_exact_ops failed")
        bad += int((~same_bits(q, a / b)).sum())
        total += a.numel()
    print(f"phase2 design div_rn_exact differs from '/' on {bad} of {total} pairs", flush=True)
    check(bad == 0, "div_rn_exact is not '/'")

    # the barrier and border exchange a sweep: A2's device time for 1 and 25
    # sweeps (tol 0) at 512² B=1
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    g = (wheel[None] + 5.0 * torch.randn((1, 512, 512), generator=gen, device=dev)).contiguous()
    lam = torch.tensor(0.02, device=dev)
    t = {n: device_us(torch, lambda n=n: tv_cuda.chambolle_prox_cuda(
        g, lam, n, tol=0.0, return_state=False), "resident", calls=10) for n in (1, 25)}
    slope = (t[25] - t[1]) / 24
    print(f"phase2 barrier cost 512x512 B=1: A2 device {t[1]:.2f} us (1 sweep), {t[25]:.2f} us "
          f"(25 sweeps): {slope:.3f} us a sweep, sweep and barrier together [{tag}]", flush=True)

    # one launch a call: every kernel a profiled call of A1, A2, B and C runs
    px0 = torch.zeros_like(g)
    sc = (torch.tensor(1.9, device=dev), torch.tensor(2.0, device=dev), lam)
    seeds = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    scal = torch.tensor([0.08, 0.249, 1e-3], device=dev)
    calls = {
        "A1": lambda: tv_cuda.chambolle_prox_cuda(g, lam, 10, duals=(px0, px0)),
        "A2": lambda: tv_cuda.chambolle_prox_cuda(g, lam, 25, return_state=False),
        "B": lambda: fused_step_cuda.myula_prox_tv(g, g, px0, px0, *sc, 25),
        "C": lambda: fused_step_cuda.myula_prox_tv_rng(g, g, px0, seeds, *sc, 25),
        "J": lambda: pv.prox_variant("base", g, scal, 25),
    }
    listing = {}
    for name, fn in calls.items():
        listing[name] = [(e.key.replace("(anonymous namespace)::", "").split("(")[0], e.count)
                         for e in profiled(torch, fn, 1) if e.device_time_total > 0]
    print(f"phase2 kernels a profiled call runs: {json.dumps(listing)}", flush=True)
    for name, ks in listing.items():
        check(len(ks) == 1 and ks[0][1] == 1
              and ("variant_prox" if name == "J" else "resident") in ks[0][0],
              f"{name} is not one launch: {ks}")
    check(tv_cuda.barrier_error() == 0, "a barrier gave up")
    return dict(occupancy=occ, ptxas=ptxas, sweep_us=slope)


def mid_pass_scale(torch, img, lam, prox_plain, K=8):
    """A scale s at which the plain prox of s·img stops inside a pass of K
    sweeps (2 ≤ sweeps ≤ 23, not a multiple of K): the middle of the run of
    scales that stop on such a sweep, found on the card."""
    import numpy as np

    def iters(logs):
        g = img[None] * torch.tensor(10.0 ** logs, dtype=img.dtype, device=img.device)[:, None, None]
        return prox_plain(g.contiguous(), lam, 25)[1].iters.cpu().numpy()

    coarse = np.linspace(-12.0, 1.0, 53)
    its = iters(coarse)
    lo = coarse[np.nonzero(its == 1)[0].max()] if (its == 1).any() else coarse[0]
    hi = coarse[np.nonzero(its == 25)[0].min()] if (its == 25).any() else coarse[-1]
    fine = np.linspace(lo, hi, 64)
    f_its = iters(fine)
    ok = [t for t in range(2, 24) if t % K and (f_its == t).sum() >= 1]
    check(ok, f"no scale stops inside a pass: {f_its.tolist()}")
    # prefer a stop after the first pass: its redo starts from a ping-pong
    # buffer, not from the virgin duals
    target = max(ok, key=lambda t: (t > K and (f_its == t).sum() >= 2, (f_its == t).sum()))
    return float(10.0 ** np.median(fine[f_its == target])), target


def phase5_kernels(torch, dev, tv_cuda, fused_step_cuda, tb, wheel, tag):
    """Blocked kernel vs plain vs the resident kernel (A2/A1/B) at the large
    path's shapes."""
    g0 = torch.Generator(device=dev)
    g0.manual_seed(5)
    rows = {"F": "tiled", "G": "tiled", "H": "streamed", "I": "streamed"}
    stats = {k: dict(max_abs_err=0.0, ms=None, plain_ms=None, resident_ms=None) for k in rows}
    lam_sapg = torch.tensor(0.02, device=dev)
    lam_salsa = torch.tensor(100.0, device=dev)
    # a natural image at every size: wheel.png tiled (it is 512²)
    reps = -(-max(max(s[1:]) for s in KERNEL_SHAPES) // wheel.shape[0])
    big = wheel.repeat(reps, reps)
    exits = []
    for B, M, N in KERNEL_SHAPES:
        prox_row, step_row = ("F", "G") if tb.blocked_rung((M, N)) == "tiled" else ("H", "I")
        img = big[:M, :N]
        noise = lambda s=1.0: torch.randn((B, M, N), generator=g0, device=dev) * s
        base = (img[None] + 5.0 * noise()).contiguous()
        if B == 1:
            scales = torch.ones(1, device=dev)
        elif B == 3:   # one chain that stops inside a pass, one flat, one full
            s_mid, t_mid = mid_pass_scale(torch, base[0], lam_sapg, tb.chambolle_prox_blocked_plain)
            scales = torch.tensor([s_mid, 1e-10, 1.0], device=dev)
            print(f"phase5 {M}x{N}: chain 0 scaled by {s_mid:.4g} to stop after {t_mid} "
                  "sweeps (plain)", flush=True)
        else:
            scales = torch.logspace(0, -10, B, device=dev)
        scales = scales[:, None, None]
        g = (base * scales).contiguous()
        px0, py0 = (noise(0.1) * scales).contiguous(), (noise(0.1) * scales).contiguous()

        kf, kst = tb.chambolle_prox_blocked(g, lam_sapg, 25, tol=0.0, return_state=False)
        pf, pst = tb.chambolle_prox_blocked_plain(g, lam_sapg, 25, tol=0.0, return_state=False)
        e_f = rel(kf, pf)
        _, kst1 = tb.chambolle_prox_blocked(g, lam_sapg, 25, tol=1e-3, return_state=False)
        _, pst1 = tb.chambolle_prox_blocked_plain(g, lam_sapg, 25, tol=1e-3, return_state=False)
        it_k, it_p = kst1.iters.tolist(), pst1.iters.tolist()
        wf, wst = tb.chambolle_prox_blocked(g, lam_salsa, 10, tol=0.0, duals=(px0, py0))
        qf, qst = tb.chambolle_prox_blocked_plain(g, lam_salsa, 10, tol=0.0, duals=(px0, py0))
        e_w = max(rel(wf, qf), rel(wst.px, qst.px), rel(wst.py, qst.py))
        _, wst1 = tb.chambolle_prox_blocked(g, lam_salsa, 10, duals=(px0, py0))
        _, qst1 = tb.chambolle_prox_blocked_plain(g, lam_salsa, 10, duals=(px0, py0))
        wit_k, wit_p = wst1.iters.tolist(), qst1.iters.tolist()
        stats[prox_row]["max_abs_err"] = max(
            stats[prox_row]["max_abs_err"],
            max_abs([(kf, pf), (wf, qf), (wst.px, qst.px), (wst.py, qst.py)]))

        x = (img[None] + noise(5.0)).abs().contiguous()
        prox = (x + noise(0.1)).contiguous()
        grad = noise(0.01).contiguous()
        z = noise().contiguous()
        sc = (torch.tensor(1.9, device=dev), torch.tensor(2.0, device=dev), lam_sapg)
        e_s = {}
        for s2 in (1.0, 2.5):
            s2_t = torch.tensor(s2, device=dev)
            kb = fused_step_cuda.myula_prox_tv_blocked(x, prox, grad, z, *sc, s2_t, tol=0.0)
            pb = fused_step_cuda.myula_prox_tv_blocked_plain(x, prox, grad, z, *sc, s2_t, tol=0.0)
            e_s[s2] = [rel(a, b) for a, b in zip(kb, pb)]
            stats[step_row]["max_abs_err"] = max(stats[step_row]["max_abs_err"],
                                                 max_abs(zip(kb[:2], pb[:2])))
        torch.cuda.synchronize()
        print(f"phase5 B={B} {M}x{N}: {prox_row} fresh tol=0 rel {e_f:.3e}; tol=1e-3 iters "
              f"kernel {it_k} plain {it_p}; warm tol=0 rel {e_w:.3e}; warm tol=1e-3 iters "
              f"kernel {wit_k} plain {wit_p}; {step_row} σ²=1 rel xn/proxn/tv "
              f"{'/'.join(f'{v:.3e}' for v in e_s[1.0])}, σ²=2.5 "
              f"{'/'.join(f'{v:.3e}' for v in e_s[2.5])} (bound {REL_BOUND:g})", flush=True)
        check(e_f <= REL_BOUND, f"{prox_row} fresh disagrees: {e_f}")
        check(e_w <= REL_BOUND, f"{prox_row} warm disagrees: {e_w}")
        check(max(max(v) for v in e_s.values()) <= REL_BOUND, f"{step_row} disagrees: {e_s}")
        check(kst.iters.tolist() == pst.iters.tolist() == [25] * B, "tol=0 must run 25 sweeps")
        check(it_k == it_p, f"{prox_row} sweep counts differ: {it_k} vs {it_p}")
        check(wit_k == wit_p, f"{prox_row} warm sweep counts differ: {wit_k} vs {wit_p}")
        exits += [((M, N), t) for t in it_k if inside_pass(tb, t, 25)]
        exits += [((M, N), t) for t in wit_k if inside_pass(tb, t, 10)]

        # the resident kernel on the same inputs (the walk form at these
        # sizes): bit-equal to the plain versions above, which are its own;
        # B with gradF = grad/σ² at σ² = 2.5 (pb, the loop's last)
        s2_t = torch.tensor(2.5, device=dev)
        grad_div = (grad / s2_t).contiguous()
        geo = tv_cuda.resident_geometry(B, M, N, tv_cuda.resident_capacity(dev))
        rf, _ = tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, tol=0.0, return_state=False)
        _, rst1 = tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, tol=1e-3, return_state=False)
        rwf, rwst = tv_cuda.chambolle_prox_cuda(g, lam_salsa, 10, tol=0.0, duals=(px0, py0))
        _, rwst1 = tv_cuda.chambolle_prox_cuda(g, lam_salsa, 10, duals=(px0, py0))
        rb = fused_step_cuda.myula_prox_tv(x, prox, grad_div, z, *sc, 25, tol=0.0)
        e_r = max_abs([(rf, pf), (rwf, qf), (rwst.px, qst.px), (rwst.py, qst.py),
                       (rb[0], pb[0]), (rb[1], pb[1])])
        e_rtv = rel(rb[2], pb[2])
        r_it, rw_it = rst1.iters.tolist(), rwst1.iters.tolist()
        code = tv_cuda.barrier_error()
        print(f"phase5 resident B={B} {M}x{N}: geometry {geo.tiles} tiles a chain, walk "
              f"{geo.walk} tiles a block, grid {geo.grid}; A2/A1/B max|Δ| {e_r:g}, B tv rel "
              f"{e_rtv:.3e}; iters A2 {r_it}, A1 {rw_it}; barrier error code {code}", flush=True)
        check(code == 0, f"a barrier gave up (code {code})")
        check(e_r == 0.0, f"the resident kernel is not bit-equal to plain at {M}x{N}: {e_r}")
        check(e_rtv <= REL_BOUND, f"B's TV differs at {M}x{N}: {e_rtv}")
        check(r_it == it_p and rw_it == wit_p,
              f"resident sweep counts differ at {M}x{N}: {r_it} vs {it_p}, {rw_it} vs {wit_p}")

        times = {
            f"{prox_row} fresh": (
                lambda: tb.chambolle_prox_blocked(g, lam_sapg, 25, return_state=False),
                lambda: tb.chambolle_prox_blocked_plain(g, lam_sapg, 25, return_state=False),
                lambda: tv_cuda.chambolle_prox_cuda(g, lam_sapg, 25, return_state=False)),
            f"{prox_row} warm": (
                lambda: tb.chambolle_prox_blocked(g, lam_salsa, 10, duals=(px0, py0)),
                lambda: tb.chambolle_prox_blocked_plain(g, lam_salsa, 10, duals=(px0, py0)),
                lambda: tv_cuda.chambolle_prox_cuda(g, lam_salsa, 10, duals=(px0, py0))),
            step_row: (
                lambda: fused_step_cuda.myula_prox_tv_blocked(x, prox, grad, z, *sc, s2_t),
                lambda: fused_step_cuda.myula_prox_tv_blocked_plain(x, prox, grad, z, *sc, s2_t),
                lambda: fused_step_cuda.myula_prox_tv(x, prox, grad_div, z, *sc)),
        }
        for name, (fk, fp, f1) in times.items():
            mk, mp, m1 = cuda_ms(fk), cuda_ms(fp), cuda_ms(f1)
            print(f"phase5 time {name} B={B} {M}x{N}: blocked {mk * 1e3:.1f} us, plain "
                  f"{mp * 1e3:.1f} us, resident kernel {m1 * 1e3:.1f} us per call [{tag}]",
                  flush=True)
            row = name.split()[0]
            if B == 1 and name != f"{prox_row} warm":
                stats[row].update(ms=mk, plain_ms=mp, resident_ms=m1)
        if B == 1:   # the timed calls' work (tol=1e-3; the step at σ² = 2.5)
            step_its = tb.chambolle_prox_blocked(kb[0], lam_sapg, 25, return_state=False)[1]
            stats[prox_row]["work"] = prox_work(B, M, N, sum(it_k))
            stats[step_row]["work"] = step_work(B, M, N, sum(step_its.iters.tolist()))
    print(f"phase5 sweep counts of chains that stopped inside a pass: {exits}", flush=True)
    for shape in ((STREAMED, STREAMED), (1000, 1528)):
        check(any(s == shape for s, _ in exits),
              f"no chain stopped inside a pass at {shape}: the redo was not exercised there")
    return stats


def inside_pass(tb, t, n):
    """Whether a chain that stopped after t of n sweeps stopped inside a
    pass of tb.pass_split(n), so that its pass was redone."""
    ends, e = set(), 0
    for k in tb.pass_split(n):
        e += k
        ends.add(e)
    return t < n and t not in ends


def device_us(torch, fn, name, calls=5):
    """Device µs a call of the kernels whose name holds `name`
    (torch.profiler), after one warm-up call."""
    return sum(e.device_time_total for e in profiled(torch, fn, calls) if name in e.key) / calls


def blocked_prox_raw(torch, lib, tb, g, lam, max_iter, geometry):
    """The fresh blocked prox (tol 0) of g, (B, M, N) float32 on the card,
    through sb_chambolle_prox_blocked on the tiles `geometry` = (TY, TX, K),
    which the wrapper would take from blocked_geometry(max_iter)."""
    B, M, N = g.shape
    TYb, TXb, K = geometry
    dev = g.device
    px_buf = torch.empty((2, B, M, N), device=dev)
    py_buf = torch.empty_like(px_buf)
    state = torch.empty((B, tb.STATE_COLS), dtype=torch.int32, device=dev)
    err = torch.empty((B,), device=dev)
    partials = torch.empty((B * K * -(-M // TYb) * -(-N // TXb),), device=dev)
    f = torch.empty_like(g)
    check(lib.sb_chambolle_prox_blocked(
        g.data_ptr(), lam.data_ptr(), None, None, px_buf.data_ptr(), py_buf.data_ptr(),
        state.data_ptr(), err.data_ptr(), partials.data_ptr(), f.data_ptr(), None, None,
        B, M, N, TYb, TXb, K, max_iter, 0.249, 0.0, 0, torch.cuda.current_stream().cuda_stream)
        == 0,
        "sb_chambolle_prox_blocked failed")
    return f


def phase5_design(torch, dev, tb, tv_cuda, build, wheel, tag):
    """The pass kernel's registers, spills, occupancy, halo and split; its
    fast operators against IEEE; the fixed share of a pass; the blocked prox
    beside A2 at 512² B=16.  Returns the design numbers."""
    import ctypes

    lib = build.load_library()
    occ = (ctypes.c_int * 5)()
    check(lib.sb_blocked_occupancy(occ) == 0, "sb_blocked_occupancy failed")
    blocks, regs, local, threads, bound_blocks = list(occ)
    ptxas = None
    for u in build.kernel_usage("blocked_pass").values():
        ptxas = (u["registers"], u["spill_stores"], u["spill_loads"])
    design = dict(threads=threads, registers=regs, local_bytes=local, blocks_per_sm=blocks,
                  launch_bounds_blocks=bound_blocks, ptxas=ptxas)
    for n in (25, 10):
        geo = tb.blocked_geometry(n)
        design[f"split_{n}"] = geo[3]
        design[f"tile_{n}"] = geo[:3]
        design[f"halo_factor_{n}"] = round(tb.halo_factor(geo), 4)
    print(f"phase5 design blocked_pass: ptxas (registers, spill stores, spill loads) "
          f"{ptxas}; runtime {regs} registers, "
          f"{local} local bytes; "
          f"{threads} threads, {blocks} active blocks per SM (__launch_bounds__ {bound_blocks}); "
          f"25 sweeps: passes {design['split_25']}, tile (TY, TX, K) {design['tile_25']}, halo "
          f"factor {design['halo_factor_25']}; 10 sweeps: passes {design['split_10']}, tile "
          f"{design['tile_10']}, halo factor {design['halo_factor_10']}", flush=True)
    check(blocks == bound_blocks, f"blocked_pass: {blocks} blocks per SM, the design counts on "
          f"{bound_blocks}")
    check(local == 0 and (ptxas is None or ptxas[1] == ptxas[2] == 0),
          f"blocked_pass spills: ptxas {ptxas}, {local} local bytes")

    # the fast quotient and root against the IEEE operators over their range
    stream = torch.cuda.current_stream().cuda_stream
    lo, hi = (127 - 94) << 23, (127 + 60) << 23
    bad_root = 0
    for start in range(lo, hi + 1, 1 << 27):
        x = torch.arange(start, min(start + (1 << 27), hi + 1), dtype=torch.int32,
                         device=dev).view(torch.float32)
        q, r = torch.empty_like(x), torch.empty_like(x)
        check(lib.sb_blocked_fast_ops(x.data_ptr(), torch.ones_like(x).data_ptr(), q.data_ptr(),
                                      r.data_ptr(), x.numel(), stream) == 0, "fast_ops failed")
        bad_root += int((r.view(torch.int32) != torch.sqrt(x).view(torch.int32)).sum())
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    bad_div, n_div = 0, 0
    for _ in range(4):
        m = 1 << 26
        a = torch.exp2(torch.rand(m, generator=gen, device=dev) * 154 - 94)
        a = torch.where(torch.rand(m, generator=gen, device=dev) < 0.5, -a, a)
        b = torch.exp2(torch.rand(m, generator=gen, device=dev) * 31)
        q, r = torch.empty_like(a), torch.empty_like(a)
        lib.sb_blocked_fast_ops(a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(), m, stream)
        bad_div += int((q.view(torch.int32) != (a / b).view(torch.int32)).sum())
        n_div += m
    print(f"phase5 design fast operators: sqrt differs from IEEE on {bad_root} of "
          f"{hi - lo + 1} floats in [2^-94, 2^60]; a/b on {bad_div} of {n_div} samples "
          f"(|a| in [2^-94, 2^60], b in [1, 2^31])", flush=True)
    check(bad_root == 0 and bad_div == 0, "the fast operators differ from IEEE in their range")

    # the cost of a sweep and the fixed cost of a pass: device time of one
    # pass of 1 and of 7 sweeps on the 25-sweep budget's tiles (halo 7),
    # through the C entry, which takes the tiles from its caller
    g = (wheel.repeat(4, 4)[None] + 5.0 * torch.randn((1, STREAMED, STREAMED), generator=gen,
                                                         device=dev)).contiguous()
    lam = torch.tensor(0.02, device=dev)
    geo = tb.blocked_geometry(25)[:3]
    t = {n: device_us(torch, lambda n=n: blocked_prox_raw(torch, lib, tb, g, lam, n, geo),
                      "blocked_pass", calls=10) for n in (1, 7)}
    sweep = (t[7] - t[1]) / 6
    design.update(pass1_us=t[1], pass7_us=t[7], sweep_us=sweep,
                  fixed_share=(t[1] - sweep) / t[7])
    print(f"phase5 design one pass at {STREAMED}x{STREAMED} B=1, tile {geo}: blocked_pass device "
          f"{t[1]:.1f} us (1 sweep), {t[7]:.1f} us (7 sweeps): {sweep:.2f} us a sweep, fixed "
          f"{t[1] - sweep:.1f} us a pass, {design['fixed_share']:.3f} of a 7-sweep pass [{tag}]",
          flush=True)

    # the blocked prox beside A2 at 512² B=16, same inputs (phase 2's kind)
    B = 16
    g = ((wheel[None] + 5.0 * torch.randn((B, 512, 512), generator=gen, device=dev))
         * torch.logspace(0, -10, B, device=dev)[:, None, None]).contiguous()
    kb, sb = tb.chambolle_prox_blocked(g, lam, 25, return_state=False)
    ka, sa = tv_cuda.chambolle_prox_cuda(g, lam, 25, return_state=False)
    mb = cuda_ms(lambda: tb.chambolle_prox_blocked(g, lam, 25, return_state=False))
    ma = cuda_ms(lambda: tv_cuda.chambolle_prox_cuda(g, lam, 25, return_state=False))
    torch.cuda.synchronize()
    design.update(a2_512_b16_ms=ma, blocked_512_b16_ms=mb)
    print(f"phase5 design 512x512 B=16 fresh prox, tol 1e-3: blocked {mb * 1e3:.1f} us, A2 "
          f"{ma * 1e3:.1f} us (ratio {mb / ma:.3f}); sweeps blocked {sb.iters.tolist()}, A2 "
          f"{sa.iters.tolist()}; rel {rel(kb, ka):.3e} [{tag}]", flush=True)
    check(sb.iters.tolist() == sa.iters.tolist(), "blocked and A2 sweep counts differ at 512²")
    return design


def prepared_step(torch, problem, B, route=None):
    """(step, carry, draw) of the SAPG step through `route` (None: the
    default) from y, as run_sapg starts its main scan; a step that draws its
    noise in the kernel gets (B, 2) seeds, and under track_posterior_moments
    the carry holds zero moments."""
    from semiblind_tv_tpu_torch.sapg.estimator import (
        generator_noise,
        generator_seeds,
        make_sapg_step,
    )

    dev = problem.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    step, aux = make_sapg_step(problem, B, route=route)
    shape = (B,) + problem.blur.shape
    if aux["in_kernel_rng"](B):
        seeds = generator_seeds(gen, dev)
        draw = lambda: seeds(B)  # noqa: E731
    else:
        noise = generator_noise(gen, problem.blur.dtype, dev)
        draw = lambda: noise(shape)  # noqa: E731
    X = problem.y.expand(shape).contiguous()
    prox = aux["prox_b"](X, aux["lam"] * aux["theta0"])[0]
    carry = aux["main_carry"]((X, problem.blur.rfft(X), prox), aux["consts"])
    return step, carry, draw


def step_rate(torch, problem, B, route, n_steps=200, warm=20):
    """SAPG chain-iter/s of the step through `route` (None: the default)."""
    step, carry, draw = prepared_step(torch, problem, B, route)
    for ii in range(2, 2 + warm):
        carry, _ = step(carry, ii, draw())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ii in range(2 + warm, 2 + warm + n_steps):
        carry, _ = step(carry, ii, draw())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(bool(torch.isfinite(carry[0]).all()), "non-finite chain state in the rate run")
    return n_steps * B / dt


def check_demo(results, sapg, salsa, problem, cfg, shape, tag):
    import numpy as np

    scalars = [results[k] for k in ("theta_EB", "sigma2_EB", "mse_db", "ssim", "snr_db",
                                    "psnr_db")]
    check(all(np.isfinite(scalars)), f"{tag}: non-finite results {scalars}")
    check(np.all(np.isfinite(sapg.thetas)) and np.all(np.isfinite(sapg.sigma2s))
          and np.all(np.isfinite(salsa.x)), f"{tag}: non-finite traces")
    lo, hi = cfg.theta.box
    check(lo <= results["theta_EB"] <= hi, f"{tag}: theta_EB outside its box")
    s_lo, s_hi = (float(v) for v in problem.sigma2_box)
    check(s_lo <= results["sigma2_EB"] <= s_hi, f"{tag}: sigma2_EB outside its box")
    for s in cfg.psf_params:
        v = results["psf_params_EB"][s.name]
        check(s.box[0] <= v <= s.box[1], f"{tag}: {s.name}_EB outside its box")
    check(results["mse_db"] < results["mse_db_observation"], f"{tag}: MAP no better than y")
    check(salsa.x.shape == shape, f"{tag}: wrong MAP shape")


def phase5_demos(torch, tv_cuda, fused_step_cuda, tb, run_demo, presets, tag):
    """run_demo at 2048² (three families) and 1024²; launches per row."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters
    from semiblind_tv_tpu_torch.utils.images import load_image

    gaussian_preset, laplace_preset, moffat_preset = presets
    runs = [
        ("gaussian w free, sigma-log-scale", STREAMED,
         gaussian_preset(fix_w1=False, fix_w2=False), dict(sigma_log_scale=True)),
        ("laplace", STREAMED, laplace_preset(), {}),
        ("moffat", STREAMED, moffat_preset(), {}),
        ("gaussian preset (w pinned)", TILED, gaussian_preset(), {}),
    ]
    launches = {"F": 0, "G": 0, "H": 0, "I": 0}
    for name, size, cfg, extra in runs:
        cfg = dataclasses.replace(cfg, image="synthetic",
                                  sapg=dataclasses.replace(cfg.sapg, **DEMO_BUDGET, **extra))
        image = load_image("synthetic", size=size)
        counters.reset("launches.A", "launches.A.fresh", "launches.B", "launches.blocked_step",
                       "launches.blocked_prox", "launches.blocked_prox.fresh")
        t0 = time.perf_counter()
        results, sapg, salsa, problem = run_demo(cfg, image, n_chains=1, device="cuda")
        wall = time.perf_counter() - t0
        counts = {"blocked prox": counters["launches.blocked_prox"],
                  "blocked fresh": counters["launches.blocked_prox.fresh"],
                  "blocked step": counters["launches.blocked_step"], "A": counters["launches.A"],
                  "B": counters["launches.B"]}
        print(f"phase5 demo {size}x{size} {name}: " + json.dumps(results), flush=True)
        print(f"phase5 demo {size}x{size} {name}: launches {json.dumps(counts)}; sigma2_EB "
              f"{results['sigma2_EB']:.4f} vs truth {results['sigma2_true']:.4f}; mse_db "
              f"{results['mse_db']:.3f} vs y {results['mse_db_observation']:.3f}; SAPG "
              f"{results['sapg_time_s']:.3f} s, SALSA {results['salsa_time_s']:.3f} s "
              f"({results['salsa_iters']} iters), wall {wall:.3f} s [{tag}]", flush=True)
        check(counts["blocked prox"] > 0 and counts["blocked step"] > 0,
              f"{name}: the blocked kernels were not launched")
        check(counts["A"] == 0 and counts["B"] == 0,
              f"{name}: kernel A or B ran on the >512² path")
        check_demo(results, sapg, salsa, problem, cfg, (size, size), name)
        prox_row, step_row = ("F", "G") if size == TILED else ("H", "I")
        launches[prox_row] += counts["blocked prox"]
        launches[step_row] += counts["blocked step"]
    return launches


def phase5_card_vs_plain(torch, dev, run_demo, gaussian_preset, tag):
    """The 1024² pipeline through the blocked kernels and through their
    plain versions on the card, with the same injected noise."""
    from semiblind_tv_tpu_torch.utils.images import load_image

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    cfg = dataclasses.replace(
        cfg, image="synthetic",
        sapg=dataclasses.replace(cfg.sapg, samples=60, warmup=30, burn_in=48),
        salsa=dataclasses.replace(cfg.salsa, outer_iters=60))
    image = load_image("synthetic", size=TILED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    obs = torch.randn((TILED, TILED), generator=gen, device=dev)
    draws = [torch.randn((1, TILED, TILED), generator=gen, device=dev) for _ in range(29 + 59)]

    def injected():
        it = iter(draws)
        return lambda shape: next(it)

    r_k, *_ = run_demo(cfg, image, device="cuda", obs_noise=obs, noise=injected())
    r_p, *_ = run_demo(cfg, image, device="cuda", obs_noise=obs, noise=injected(), plain=True)
    agree = {k: abs(r_k[k] - r_p[k]) / abs(r_p[k]) for k in ("theta_EB", "sigma2_EB", "mse_db")}
    print(f"phase5 {TILED}x{TILED} blocked vs plain on the card, 60 SAPG + 60 SALSA: relative "
          f"differences {json.dumps(agree)} (bound 1e-3); SAPG s blocked "
          f"{r_k['sapg_time_s']:.3f} plain {r_p['sapg_time_s']:.3f} [{tag}]", flush=True)
    for k, v in agree.items():
        check(v <= 1e-3, f"blocked and plain disagree at {TILED}² on {k}: {v}")


def phase5_rates(torch, dev, build_problem, gaussian_preset, salsa_tv, tag):
    import numpy as np

    from semiblind_tv_tpu_torch.utils.images import load_image

    free = gaussian_preset(fix_w1=False, fix_w2=False)
    for size, chains in ((TILED, (4,)), (STREAMED, (1, 2))):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        prob = build_problem(load_image("synthetic", size=size), free, gen, device=dev)
        for B in chains:
            rb = step_rate(torch, prob, B, None, n_steps=60, warm=5)
            r1 = step_rate(torch, prob, B, "B", n_steps=60, warm=5)
            rp = step_rate(torch, prob, B, "plain", n_steps=15, warm=2)
            print(f"phase5 SAPG step {size}x{size} B={B} (w free): blocked {rb:.1f}, "
                  f"kernel B {r1:.1f}, plain {rp:.1f} chain-iter/s [{tag}]", flush=True)
    pinned = build_problem(load_image("synthetic", size=STREAMED), gaussian_preset(), gen,
                           device=dev)
    rw = step_rate(torch, pinned, 1, None, n_steps=100, warm=10)
    print(f"phase5 SAPG step {STREAMED}x{STREAMED} B=1 (w pinned): blocked {rw:.1f} chain-iter/s, "
          f"{1e3 / rw:.3f} ms a step [{tag}]", flush=True)
    theta, sig2 = 0.05, float(prob.sigma_true) ** 2
    kw = dict(tau=theta * sig2, mu=theta * 0.1, blur=prob.blur, tol=0.0)
    salsa_tv(prob.y, prob.H_true, max_iter=10, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = salsa_tv(prob.y, prob.H_true, max_iter=100, **kw)
    dt = time.perf_counter() - t0
    check(res.n_iters == 100 and np.all(np.isfinite(res.x)), "SALSA 2048² run failed")
    print(f"phase5 SALSA {STREAMED}x{STREAMED} 100 outer iterations (tol 0), blocked warm prox: "
          f"{dt:.3f} s [{tag}]", flush=True)


# the launch counters (profiling.counters, `launches.<name>`) of each ops module
LAUNCH_COUNTERS = {
    "tv_cuda": ("A", "A.fresh"),
    "tv_blocked_cuda": ("blocked_prox", "blocked_prox.fresh"),
    "fused_step_cuda": ("B", "C", "blocked_step", "blocked_step.seeds"),
    "fused_dft_cuda": ("D", "E", "dft_products"),
}


def reset_counters(*modules):
    """Zero the launch counters of the wrappers in `modules`."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters

    for m in modules:
        counters.reset(*("launches." + k for k in LAUNCH_COUNTERS[m.__name__.rsplit(".", 1)[1]]))


def phase6_noise_kernels(torch, dev, fs, big, tag):
    """Kernel C and I's seeds form against their plain versions (the noise
    drawn from the same seeds), with B and I fed that noise as a field for
    the time comparison; the raw noise field's moments."""
    from semiblind_tv_tpu_torch.ops import tv_blocked_cuda as tb
    from semiblind_tv_tpu_torch.ops import tv_cuda
    from semiblind_tv_tpu_torch.ops.rng import philox_normals

    g0 = torch.Generator(device=dev)
    g0.manual_seed(6)
    stats = {k: dict(max_abs_err=0.0, ms=None, plain_ms=None) for k in ("C", "I[seeds]")}
    sc = (torch.tensor(1.9, device=dev), torch.tensor(2.0, device=dev),
          torch.tensor(0.02, device=dev))
    s2 = torch.tensor(2.5, device=dev)
    cases = [("C", s) for s in ((1, 512, 512), (16, 512, 512), (3, 481, 353))] + \
            [("I[seeds]", s) for s in ((1, STREAMED, STREAMED), (2, STREAMED, STREAMED),
                                       (3, 1000, 1528))]
    for row, (B, M, N) in cases:
        noise = lambda s=1.0: torch.randn((B, M, N), generator=g0, device=dev) * s
        x = (big[None, :M, :N] + noise(5.0)).abs().contiguous()
        prox = (x + noise(0.1)).contiguous()
        grad = noise(0.01).contiguous()
        seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), generator=g0, dtype=torch.int32,
                              device=dev)
        z = philox_normals(seeds, (M, N))
        if row == "C":
            kern = lambda tol=1e-3: fs.myula_prox_tv_rng(x, prox, grad, seeds, *sc, 25, tol=tol)
            plain = lambda tol=1e-3: fs.myula_prox_tv_rng_plain(x, prox, grad, seeds, *sc, 25,
                                                                tol=tol)
            field = lambda: fs.myula_prox_tv(x, prox, grad, z, *sc, 25)
            other = "B"
        else:
            kern = lambda tol=1e-3: fs.myula_prox_tv_blocked(x, prox, grad, None, *sc, s2,
                                                             tol=tol, seeds=seeds)
            plain = lambda tol=1e-3: fs.myula_prox_tv_blocked_plain(x, prox, grad, None, *sc, s2,
                                                                    tol=tol, seeds=seeds)
            field = lambda: fs.myula_prox_tv_blocked(x, prox, grad, z, *sc, s2)
            other = "I"
        k, p = kern(0.0), plain(0.0)
        e = [rel(a, b) for a, b in zip(k, p)]
        stats[row]["max_abs_err"] = max(stats[row]["max_abs_err"], max_abs(zip(k[:2], p[:2])))
        torch.cuda.synchronize()
        mk, mp, mf = cuda_ms(kern), cuda_ms(plain), cuda_ms(field)
        print(f"phase6 {row} B={B} {M}x{N}: rel xn/proxn/tv "
              f"{'/'.join(f'{v:.3e}' for v in e)} (bound {REL_BOUND:g}); kernel {mk * 1e3:.1f} us, "
              f"plain {mp * 1e3:.1f} us, {other} fed the same noise as a field "
              f"{mf * 1e3:.1f} us per call [{tag}]", flush=True)
        check(max(e) <= REL_BOUND, f"{row} disagrees with its plain version: {e}")
        if B == 1 and M in (512, STREAMED):
            prox = tv_cuda.chambolle_prox_cuda if row == "C" else tb.chambolle_prox_blocked
            its = prox(k[0], sc[2], 25, return_state=False)[1].iters.tolist()
            stats[row].update(ms=mk, plain_ms=mp, work=step_work(B, M, N, sum(its), seeds=True))

    # x = prox = grad = 0, γ = 0.5, positivity off: xn is the raw noise field
    zero = torch.zeros((16, 512, 512), device=dev)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (16, 2), generator=g0, dtype=torch.int32,
                          device=dev)
    zf = fs.myula_prox_tv_rng(zero, zero, zero, seeds, 0.5, 1.0, 0.02, 1,
                              positivity=False)[0].double()
    n = zf.numel()
    mom = [float(zf.mean()), float(zf.var()), float((zf ** 3).mean()), float((zf ** 4).mean())]
    print(f"phase6 C raw noise 16x512x512: mean {mom[0]:.3e} var {mom[1]:.5f} third "
          f"{mom[2]:.3e} fourth {mom[3]:.4f} (bands: |mean| < {5.0 / n ** 0.5:.2e}, |var−1| < "
          f"0.05, |third| < 0.1, |fourth−3| < 0.3)", flush=True)
    check(abs(mom[0]) < 5.0 / n ** 0.5 and abs(mom[1] - 1.0) < 0.05 and abs(mom[2]) < 0.1
          and abs(mom[3] - 3.0) < 0.3, f"C's noise field fails its moment bands: {mom}")
    return stats


def phase6_dft_kernels(torch, dev, fs, fd, tv_cuda, big, tag):
    """Kernels D and E against their plain versions in float32 and float64
    on the card, and the D step against route B with cuFFT and with the
    torch.matmul DFT transforms on the same inputs."""
    from semiblind_tv_tpu_torch import _build
    from semiblind_tv_tpu_torch.ops.fourier import irfft2_matmul, rdft_matrices, rfft2_matmul

    hgmma = sass_hgmma_tf32(_build.LIB_PATH)
    notes = [ln.strip() for ln in _build.BUILD_LOG.splitlines() if "wgmma" in ln.lower()]
    print(f"phase6 SASS: {len(hgmma)} HGMMA TF32 instructions in the library, e.g. "
          f"{hgmma[:1]}; ptxas on wgmma: {notes or 'nothing'}", flush=True)
    check(hgmma, "the DFT GEMM issues no HGMMA TF32 instruction")
    g0 = torch.Generator(device=dev)
    g0.manual_seed(7)
    stats = {k: dict(max_abs_err=0.0, ms=None, plain_ms=None) for k in ("D", "E")}
    real = lambda t: torch.view_as_real(t) if t.is_complex() else t  # noqa: E731
    lam_theta = torch.tensor(0.02, device=dev)
    sc = (torch.tensor(1.9, device=dev), torch.tensor(2.0, device=dev), lam_theta,
          torch.tensor(2.5, device=dev))
    sc64 = tuple(v.double() for v in sc)
    iter_diffs = []
    timed_sweeps = {}
    for B, M, N in ((1, 256, 256), (2, 256, 256), (1, 512, 512), (16, 512, 512), (3, 480, 353)):
        mats = rdft_matrices((M, N), torch.float32, dev)
        mats64 = rdft_matrices((M, N), torch.float64, dev)
        noise = lambda s=1.0: torch.randn((B, M, N), generator=g0, device=dev) * s
        x = (big[None, :M, :N] + noise(5.0)).abs()
        prox, z = x + noise(0.1), noise()
        ghat = torch.fft.rfft2(noise())
        if B == 3:   # one chain that stops inside the run, one flat, one full
            xn1 = fd.myula_prox_tv_irdft_plain(ghat[:1], x[:1], prox[:1], z[:1], mats, *sc,
                                               tol=0.0)[0]
            s_mid, t_mid = mid_pass_scale(torch, xn1[0], lam_theta, tv_cuda.chambolle_prox_plain)
            print(f"phase6 {M}x{N}: chain 0 scaled by {s_mid:.4g} to stop after {t_mid} sweeps "
                  "(plain)", flush=True)
            scales = torch.tensor([s_mid, 1e-10, 1.0], device=dev)
        elif B > 1:
            scales = torch.logspace(0, -10, B, device=dev)
        else:
            scales = torch.ones(1, device=dev)
        x, prox, z = ((t * scales[:, None, None]).contiguous() for t in (x, prox, z))
        ghat = (ghat * scales[:, None, None]).contiguous()
        ins = (ghat, x, prox, z)
        ins64 = (ghat.to(torch.complex128), x.double(), prox.double(), z.double())
        for row, fn, plain in (("D", fd.myula_prox_tv_dft, fd.myula_prox_tv_dft_plain),
                               ("E", fd.myula_prox_tv_irdft, fd.myula_prox_tv_irdft_plain)):
            k = fn(*ins, mats, *sc, tol=0.0)
            p = plain(*ins, mats, *sc, tol=0.0)
            p64 = plain(*ins64, mats64, *sc64, tol=0.0)
            errs, ratios = [], []
            for i in [0, 1, 3][:len(k) - 1]:   # xn, proxn, x̂
                a, b, c = real(k[i]), real(p[i]), real(p64[i])
                errs.append(rel(a, b))
                ratios.append(rel(a.double(), c) / max(rel(b.double(), c), 1e-30))
                stats[row]["max_abs_err"] = max(stats[row]["max_abs_err"], max_abs([(a, b)]))
            e_tv = rel(k[2], p[2])
            ki = fn(*ins, mats, *sc, return_iters=True)[-1].tolist()
            pi = plain(*ins, mats, *sc, return_iters=True)[-1].tolist()
            torch.cuda.synchronize()
            print(f"phase6 {row} B={B} {M}x{N} tol=0: rel to plain f32 "
                  f"{'/'.join(f'{v:.3e}' for v in errs)} (xn/proxn{'/x̂' if row == 'D' else ''}), "
                  f"tv {e_tv:.3e} (bound {REL_BOUND:g}); deviation from f64 over plain f32's "
                  f"{'/'.join(f'{v:.3f}' for v in ratios)} (bound 2); tol=1e-3 sweeps kernel {ki} "
                  f"plain {pi}", flush=True)
            check(max(errs + [e_tv]) <= REL_BOUND, f"{row} disagrees with its plain version")
            check(max(ratios) <= 2.0, f"{row} deviates from float64 more than 2x plain f32")
            check(all(abs(a - b) <= 1 for a, b in zip(ki, pi)),
                  f"{row} sweep counts differ by more than one: {ki} vs {pi}")
            iter_diffs += [(row, B, M, N, c, a, b) for c, (a, b) in enumerate(zip(ki, pi)) if a != b]
            timed_sweeps[row] = sum(ki)
            check(any(1 < t < 25 for t in pi) or B != 3, "no chain stopped inside the run")

        # D's and E's products alone through the 3×TF32 GEMM against
        # torch.matmul in float32 and float64 on the same inputs
        grad, xh = fd.dft_products(ghat, x, mats)
        ref32 = (irfft2_matmul(ghat, mats), rfft2_matmul(x, mats))
        ref64 = (irfft2_matmul(ins64[0], mats64), rfft2_matmul(ins64[1], mats64))
        p_err, p_ratio = [], []
        for a, b, c in zip((grad, xh), ref32, ref64):
            a, b, c = real(a), real(b), real(c)
            p_err.append(rel(a, b))
            p_ratio.append(rel(a.double(), c) / max(rel(b.double(), c), 1e-30))
        torch.cuda.synchronize()
        print(f"phase6 products B={B} {M}x{N}: rel to torch.matmul f32 grad/x̂ "
              f"{'/'.join(f'{v:.3e}' for v in p_err)} (bound {REL_BOUND:g}); deviation from "
              f"f64 over torch.matmul f32's {'/'.join(f'{v:.3f}' for v in p_ratio)} (bound 2)",
              flush=True)
        check(max(p_err) <= REL_BOUND, "the products disagree with torch.matmul")
        check(max(p_ratio) <= 2.0, "the products deviate from float64 more than 2x torch.matmul")

        # times on the same inputs: D, E and their plain versions; route B with
        # cuFFT (the default) and with the torch.matmul DFT transforms
        s2 = sc[3]
        calls = {
            "D": lambda: fd.myula_prox_tv_dft(*ins, mats, *sc),
            "D plain": lambda: fd.myula_prox_tv_dft_plain(*ins, mats, *sc),
            "E": lambda: fd.myula_prox_tv_irdft(*ins, mats, *sc),
            "E plain": lambda: fd.myula_prox_tv_irdft_plain(*ins, mats, *sc),
            "E+rfft matmul": lambda: rfft2_matmul(fd.myula_prox_tv_irdft(*ins, mats, *sc)[0],
                                                  mats),
            "B+cuFFT": lambda: torch.fft.rfft2(fs.myula_prox_tv(
                x, prox, torch.fft.irfft2(ghat, s=(M, N)) / s2, z, *sc[:3])[0]),
            "B+matmul DFT": lambda: rfft2_matmul(fs.myula_prox_tv(
                x, prox, irfft2_matmul(ghat, mats) / s2, z, *sc[:3])[0], mats),
            # the library call for D's and E's products: torch.matmul (cuBLAS
            # fp32, TF32 off) on the same shapes
            "D products, torch.matmul": lambda: (irfft2_matmul(ghat, mats),
                                                 rfft2_matmul(x, mats)),
            "E products, torch.matmul": lambda: irfft2_matmul(ghat, mats),
            "D products, tf32x3 GEMM": lambda: fd.dft_products(ghat, x, mats),
            "E products, tf32x3 GEMM": lambda: fd.dft_products(ghat, x, mats, forward=False),
        }
        ms = {name: cuda_ms(f) for name, f in calls.items()}
        if (B, M, N) == (1, 256, 256):
            # where one chain's host time goes: each wrapper's Python and its
            # C call, and the unit costs of the work the C side now caches
            lib = _build.load_library()
            costs = (ctypes.c_double * 2)()
            buf = torch.zeros(2 * 64 * 64, device=dev)
            check(lib.sb_dft_host_costs(buf.data_ptr(), 1000, costs) == 0,
                  "sb_dft_host_costs failed")
            split = host_us(torch, lib, {
                name: (calls[name], entry) for name, entry in (
                    ("D", "sb_myula_prox_tv_dft"), ("E", "sb_myula_prox_tv_irdft"),
                    ("D products, tf32x3 GEMM", "sb_dft_products"),
                    ("B+cuFFT", "sb_myula_step"))})
            print(f"phase6 host µs a call B={B} {M}x{N}: " + ", ".join(
                f"{name} {tot:.1f} (C call {c_call:.1f}, Python {tot - c_call:.1f}; "
                f"CUDA events {ms[name] * 1e3:.1f})" for name, (tot, c_call) in split.items())
                + f"; one tensor-map encoding {costs[0]:.2f} µs, one shared-memory attribute "
                f"set {costs[1]:.2f} µs (8 and 4 a D call without the caches) [{tag}]",
                flush=True)
        if (B, M, N) in ((1, 256, 256), (16, 512, 512)):
            print(f"phase6 products B={B} {M}x{N}, device µs a call by kernel: "
                  + products_profile(torch, lambda: fd.dft_products(ghat, x, mats)), flush=True)
        print(f"phase6 time B={B} {M}x{N}: " + ", ".join(f"{n} {v * 1e3:.1f} us"
                                                         for n, v in ms.items()) + f" [{tag}]",
              flush=True)
        for row, at in (("D", (1, 256, 256)), ("E", (1, 512, 512))):
            if (B, M, N) == at:
                stats[row].update(ms=ms[row], plain_ms=ms[f"{row} plain"],
                                  library_ms=ms[f"{row} products, torch.matmul"],
                                  work=dft_step_work(B, M, N, timed_sweeps[row], row == "D"),
                                  products_ms=ms[f"{row} products, tf32x3 GEMM"],
                                  **bound(dft_products_work(B, M, N, row == "D"), PEAK_TF32,
                                          "products_bound"))
    print(f"phase6 D/E chains whose tol=1e-3 sweep count differs from the plain version's "
          f"(row, B, M, N, chain, kernel, plain): {iter_diffs}", flush=True)
    return stats


def phase6_demos(torch, fs, fd, tv_cuda, tb, run_demo, gaussian_preset, wheel_np, tag):
    """run_demo through kernels D, E, C and I's seeds form; launches per row."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters
    from semiblind_tv_tpu_torch.utils.images import load_image

    free = gaussian_preset(fix_w1=False, fix_w2=False)
    runs = [
        ("512x512 dft, fuse_dft (D)", gaussian_preset(), wheel_np, 1,
         dict(fft_mode="dft", fuse_dft=True), "D"),
        ("512x512 dft, fuse_irdft (E)", gaussian_preset(), wheel_np, 1,
         dict(fft_mode="dft", fuse_irdft=True), "E"),
        ("512x512 in_kernel_rng (C)", gaussian_preset(), wheel_np, 1,
         dict(in_kernel_rng=True), "C"),
        ("256x256 B=2 dft, fuse_dft auto (D)", gaussian_preset(), wheel_np[128:384, 128:384], 2,
         dict(fft_mode="dft"), "D"),
        ("2048x2048 w free, sigma-log-scale, in_kernel_rng (I[seeds])", free,
         load_image("synthetic", size=STREAMED), 1,
         dict(sigma_log_scale=True, in_kernel_rng=True), "I[seeds]"),
    ]
    launches = {"C": 0, "D": 0, "E": 0, "I[seeds]": 0}
    for name, cfg, image, n_chains, extra, row in runs:
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **DEMO_BUDGET, **extra))
        reset_counters(fs, fd, tv_cuda, tb)
        t0 = time.perf_counter()
        results, sapg, salsa, problem = run_demo(cfg, image, n_chains=n_chains, device="cuda")
        wall = time.perf_counter() - t0
        counts = {"D": counters["launches.D"], "E": counters["launches.E"],
                  "C": counters["launches.C"], "B": counters["launches.B"],
                  "blocked step": counters["launches.blocked_step"],
                  "I[seeds]": counters["launches.blocked_step.seeds"]}
        print(f"phase6 demo {name}: " + json.dumps(results), flush=True)
        print(f"phase6 demo {name}: launches {json.dumps(counts)}; theta_EB "
              f"{results['theta_EB']:.6f}, sigma2_EB {results['sigma2_EB']:.4f} vs truth "
              f"{results['sigma2_true']:.4f}; mse_db {results['mse_db']:.3f} vs y "
              f"{results['mse_db_observation']:.3f}; SAPG {results['sapg_time_s']:.3f} s, SALSA "
              f"{results['salsa_time_s']:.3f} s, wall {wall:.3f} s [{tag}]", flush=True)
        check(counts[row] > 0, f"{name}: kernel {row} was not launched")
        if row == "E":   # the warm-up keeps kernel B, as the JAX warm step does
            check(counts["B"] > 0, f"{name}: the warm-up did not run kernel B")
        if row == "I[seeds]":
            check(counts["I[seeds]"] == counts["blocked step"], f"{name}: a step read a z field")
        else:
            check(counts["blocked step"] == 0, f"{name}: the blocked step ran at ≤512²")
        if row in ("C", "D"):
            check(counts["B"] == 0, f"{name}: kernel B ran instead of {row}")
        check_demo(results, sapg, salsa, problem, cfg, image.shape, name)
        launches[row] += counts[row]
    return launches


def phase6_card_vs_plain(torch, dev, fd, run_demo, gaussian_preset, wheel_np, tag):
    """The 512² kernel-D pipeline through the kernels and through the plain
    versions on the card, with the same injected noise."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    cfg = dataclasses.replace(
        cfg, sapg=dataclasses.replace(cfg.sapg, samples=60, warmup=30, burn_in=48,
                                      fft_mode="dft", fuse_dft=True),
        salsa=dataclasses.replace(cfg.salsa, outer_iters=60))
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    obs = torch.randn((512, 512), generator=gen, device=dev)
    draws = [torch.randn((1, 512, 512), generator=gen, device=dev) for _ in range(29 + 59)]

    def injected():
        it = iter(draws)
        return lambda shape: next(it)

    counters.reset("launches.D")
    r_k, *_ = run_demo(cfg, wheel_np, device="cuda", obs_noise=obs, noise=injected())
    check(counters["launches.D"] == 29 + 59,
          f"the D pipeline launched D {counters['launches.D']} times")
    r_p, *_ = run_demo(cfg, wheel_np, device="cuda", obs_noise=obs, noise=injected(), plain=True)
    agree = {k: abs(r_k[k] - r_p[k]) / abs(r_p[k]) for k in ("theta_EB", "sigma2_EB", "mse_db")}
    print(f"phase6 512x512 kernel D vs plain on the card, 60 SAPG + 60 SALSA: relative "
          f"differences {json.dumps(agree)} (bound 1e-3); SAPG s kernel "
          f"{r_k['sapg_time_s']:.3f} plain {r_p['sapg_time_s']:.3f} [{tag}]", flush=True)
    for k, v in agree.items():
        check(v <= 1e-3, f"kernel D and plain disagree at 512² on {k}: {v}")


def phase6_rates(torch, dev, build_problem, gaussian_preset, wheel_np, tag):
    """SAPG chain-iter/s of the step variants on the same problem data."""
    from semiblind_tv_tpu_torch.utils.images import load_image

    free = gaussian_preset(fix_w1=False, fix_w2=False)
    variants = {
        "fft+B": {}, "dft+B": dict(fft_mode="dft", fuse_dft=False),
        "D": dict(fft_mode="dft", fuse_dft=True),
        "E": dict(fft_mode="dft", fuse_dft=False, fuse_irdft=True),
        "C": dict(in_kernel_rng=True), "I": {}, "I[seeds]": dict(in_kernel_rng=True),
    }
    cells = [(512, wheel_np, (1, 16), ("fft+B", "dft+B", "D", "E", "C")),
             (256, wheel_np[128:384, 128:384], (1, 2), ("fft+B", "D")),
             (STREAMED, load_image("synthetic", size=STREAMED), (1,), ("I", "I[seeds]"))]
    for size, image, chains, names in cells:
        probs = {}
        for n in names:
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)
            cfg = dataclasses.replace(free, sapg=dataclasses.replace(free.sapg, **variants[n]))
            probs[n] = build_problem(image, cfg, gen, device=dev)
        steps = (100, 10) if size <= 512 else (60, 5)
        for B in chains:
            rates = {n: step_rate(torch, probs[n], B, None, *steps) for n in names}
            print(f"phase6 SAPG step {size}x{size} B={B} (w free): " +
                  ", ".join(f"{n} {r:.1f}" for n, r in rates.items()) +
                  f" chain-iter/s [{tag}]", flush=True)


def phase7_kernels(torch, dev, pv, tv_cuda, build, tag):
    """Kernel J: every mode against its plain version on the card, bit-equal
    with equal sweep counts, at tol=0 (J's λ) and at a decisive tol (λ = 20,
    chains stop after a few sweeps with the residual far above round-off),
    at 512² B=1, 16, 480×352 B=3 and, in base and while, 640×1152 B=1 (more
    tiles than the card holds at once: the walk form); then base's times at
    J's point (one launch a call: phase 2's profiler listing)."""
    occ = {m: pv.variant_occupancy(m, dev) for m in pv.MODES}
    ptxas = build.kernel_usage("variant_prox")
    print(f"phase7 J design: ptxas {json.dumps(ptxas)}; runtime {json.dumps(occ)}", flush=True)
    cap = tv_cuda.resident_capacity(dev)
    check(len(ptxas) == 2 * len(pv.MODES)
          and all(o["blocks_per_sm"] * tv_cuda.resident_occupancy(dev)["sms"] >= cap
                  for o in occ.values()),
          f"J's forms hold fewer blocks than the resident geometry's {cap}")
    g0 = torch.Generator(device=dev)
    g0.manual_seed(9)
    stats = dict(max_abs_err=0.0, ms=None, plain_ms=None)
    cases = [((1, 512, 512), pv.MODES), ((16, 512, 512), pv.MODES), ((3, 480, 352), pv.MODES),
             ((1, 640, 1152), ("base", "while"))]
    for (B, M, N), modes in cases:
        geo = tv_cuda.resident_geometry(B, M, N, cap, 1)
        g = torch.rand((B, M, N), generator=g0, device=dev) * 255.0
        if B == 3:
            g[0] *= 0.25   # stops earlier at the decisive tol
        g = g.contiguous()
        # the residual grows as √(M·N): 5 at 33×40 stops after 5–7 sweeps
        decisive = 5.0 * (M * N / (33 * 40)) ** 0.5
        for lam, tol in ((0.08, 0.0), (20.0, decisive)):
            scal = torch.tensor([lam, 0.249, tol], device=dev)
            report, sweeps = [], {}
            for mode in modes:
                fk, mk = pv.prox_variant(mode, g, scal, 25)
                fp, mp = pv.prox_variant_plain(mode, g, scal, 25)
                d = float((fk - fp).abs().max())
                check(d == 0.0, f"J {mode} B={B} {M}x{N} tol={tol}: max|kernel − plain| {d}")
                sweeps[mode] = mk[:, 0].tolist()
                check(sweeps[mode] == mp[:, 0].tolist(),
                      f"J {mode} sweep counts differ: {sweeps[mode]} vs {mp[:, 0].tolist()}")
                if mode == "base":
                    stats["max_abs_err"] = max(stats["max_abs_err"], d)
                report.append(f"{mode} {d:.1e} (err rel {rel(mk[:, 1], mp[:, 1]):.1e})")
            torch.cuda.synchronize()
            print(f"phase7 J B={B} {M}x{N} ({'walk' if geo.walk > 1 else 'resident'} form, "
                  f"grid {geo.grid}) λ={lam} tol={tol:.4g}: max|kernel − plain| "
                  + ", ".join(report) + f"; sweeps {json.dumps(sweeps)}", flush=True)
            if tol:
                check(max(sweeps["while"]) < 25, "the decisive tol stopped no chain")
                check(B != 3 or sweeps["while"][0] < sweeps["while"][1],
                      "chain 0 did not stop earlier")
        check(geo.walk > 1 or N != 1152, "640×1152 did not take the walk form")
    check(tv_cuda.barrier_error() == 0, "a barrier of kernel J gave up")
    g, scal = pv.probe_inputs(16, 512, dev)
    its = pv.prox_variant("base", g, scal, 25)[1][:, 0]
    stats.update(ms=cuda_ms(lambda: pv.prox_variant("base", g, scal, 25)),
                 plain_ms=cuda_ms(lambda: pv.prox_variant_plain("base", g, scal, 25), reps=5),
                 work=prox_work(16, 512, 512, int(its.sum())))
    print(f"phase7 J base at 512x512 B=16: kernel {stats['ms'] * 1e3:.1f} us, plain "
          f"{stats['plain_ms'] * 1e3:.1f} us per call [{tag}]", flush=True)
    return stats


def phase7_probe(torch, dev, pv, tv_cuda, tag):
    """J's own run and the resident design's anatomy: every mode at 512²
    B=16 (J's default point) and B=1, 25 sweeps — J's 100 chained steps
    (CUDA events) and the kernel's device µs a call (gated_us) — beside the
    production A2 kernel on the same inputs, whose f J's base must equal to
    the bit; then noresid's and while's device µs at 1 and 25 sweeps, tol 0
    (the slope: a group-sweep's cost without and with the residual and
    exit).  Returns the launches of kernel J."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters

    counters.reset("launches.J")
    anatomy = {}
    for B in (16, 1):
        g, scal = pv.probe_inputs(B, 512, dev)
        f_base = pv.prox_variant("base", g, scal, 25)[0]
        groups = -(-B // tv_cuda.resident_geometry(B, 512, 512, tv_cuda.resident_capacity(dev),
                                                   1).chains)
        row = {}
        for mode in pv.MODES:
            line = pv.probe_mode(mode, g, scal, 25, 100, f_base)
            line["device_us"] = gated_us(torch, lambda m=mode: pv.prox_variant(m, g, scal, 25))
            line["device_us_per_group_sweep"] = line["device_us"] / (groups * 25)
            row[mode] = line
            print(f"phase7 probe B={B} 512x512 " + json.dumps(line), flush=True)
        a2 = cuda_ms(lambda: tv_cuda.chambolle_prox_cuda(g, scal[0], 25, tol=1e-3,
                                                        return_state=False))
        a2_dev = gated_us(torch, lambda: tv_cuda.chambolle_prox_cuda(
            g, scal[0], 25, tol=1e-3, return_state=False))
        f_a2, st = tv_cuda.chambolle_prox_cuda(g, scal[0], 25, tol=1e-3, return_state=False)
        same = bool(torch.equal(f_a2, f_base))
        print(f"phase7 probe B={B} 512x512 A2 (chambolle_prox_cuda, fresh) on the same inputs: "
              f"{a2 * 1e3:.1f} us a call ({a2 * 1e3 / B:.2f} us per prox per chain, "
              f"{a2 * 1e3 / B / 25:.3f} us per sweep), device {a2_dev:.1f} us, iters "
              f"{float(st.iters[0])}; J base's f bit-equal to A2's: {same} [{tag}]", flush=True)
        check(same, f"J base's f differs from A2's at 512² B={B}")
        slopes = {}
        scal0 = torch.tensor([float(scal[0]), float(scal[1]), 0.0], device=dev)
        for mode in ("noresid", "while"):
            t = {n: gated_us(torch, lambda m=mode, n=n: pv.prox_variant(m, g, scal0, n))
                 for n in (1, 25)}
            slopes[mode] = dict(us_1=t[1], us_25=t[25],
                                us_per_group_sweep=(t[25] - t[1]) / (24 * groups))
        anatomy[B] = dict(groups=groups, a2_device_us=a2_dev, a2_event_us=a2 * 1e3,
                          modes={m: dict(probe_us=v["us_per_prox_per_chain"] * B,
                                         device_us=v["device_us"],
                                         device_us_per_group_sweep=v["device_us_per_group_sweep"])
                                 for m, v in row.items()},
                          slopes=slopes)
        print(f"phase7 anatomy B={B} 512x512 {json.dumps(anatomy[B])} [{tag}]", flush=True)
    return {"J": counters["launches.J"]}


# ---------------------------------------------------------------------------
# phase 8: the run surface — checkpoint/resume, the NaN guard, the posterior
# moments, the isotropic family, FISTA, the power iteration, the profiler
# ---------------------------------------------------------------------------

PHASE8_DIR = os.path.join(HERE, "build", "phase8")   # git-ignored
CKPT_EVERY = 300
RESUME_BOUND = 1e-6


class Preempted(Exception):
    """Stands for the process being killed between two segments."""


def demo_problem(torch, build_problem, cfg, image, dev):
    """The problem and the generator exactly as run_demo makes them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    return build_problem(image, cfg, gen, device=dev), gen


def runs_rel(a, b):
    """The largest relative difference of two SAPG runs over θ, σ², the PSF
    parameter traces and X_last (each over its largest magnitude)."""
    import numpy as np

    pairs = [(a.thetas, b.thetas), (a.sigma2s, b.sigma2s), (a.X_last, b.X_last)]
    pairs += [(a.psf_param_traces[n], b.psf_param_traces[n]) for n in b.psf_param_traces]
    return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)) for x, y in pairs)


def preempt_before(seg):
    def hook(seg_idx, carry):
        if seg_idx == seg:
            raise Preempted()
        return carry
    return hook


def nan_before(seg, fired):
    """A hook that puts a NaN into X[0, 0, 0] before segment `seg`, once."""
    def hook(seg_idx, carry):
        if seg_idx == seg and not fired:
            fired.append(seg_idx)
            X = carry[0].clone()
            X[0, 0, 0] = float("nan")
            return (X,) + tuple(carry[1:])
        return carry
    return hook


def interrupted(run_sapg, problem, gen, ckpt, every, seg):
    """Run until the hook preempts the run before segment `seg`; the
    checkpoint's completed-iteration count."""
    from semiblind_tv_tpu_torch.runtime.checkpoint import load_checkpoint_arrays

    fired = False
    try:
        run_sapg(problem, gen, checkpoint_every=every, checkpoint_path=ckpt,
                 fault_hook=preempt_before(seg))
    except Preempted:
        fired = True
    check(fired, "the preemption hook did not fire")
    return int(load_checkpoint_arrays(ckpt)["done_iters"])


def phase8_resume(torch, dev, m, wheel_np, tag):
    """8a and 8b at 512² (phase 5's budget): resume after a preemption, and
    the NaN guard with and without a checkpoint."""
    from semiblind_tv_tpu_torch.runtime.checkpoint import delete_checkpoint
    from semiblind_tv_tpu_torch.runtime.profiling import counters
    from semiblind_tv_tpu_torch.sapg.estimator import SAPGDivergenceError

    fs, tv_cuda = m["fs"], m["tv_cuda"]
    cfg = m["gaussian_preset"](fix_w1=False, fix_w2=False)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **DEMO_BUDGET))
    ckpt = os.path.join(PHASE8_DIR, "resume.npz")
    delete_checkpoint(ckpt)
    t0 = time.perf_counter()
    r_full, s_full, _, _ = m["run_demo"](cfg, wheel_np, device=dev)
    t_full = time.perf_counter() - t0
    problem, gen = demo_problem(torch, m["build_problem"], cfg, wheel_np, dev)
    t0 = time.perf_counter()
    done = interrupted(m["run_sapg"], problem, gen, ckpt, CKPT_EVERY, 2)
    t_cut = time.perf_counter() - t0
    check(done == 2 * CKPT_EVERY, f"the checkpoint holds {done} iterations")
    reset_counters(fs, tv_cuda)
    t0 = time.perf_counter()
    r_res, s_res, salsa, prob = m["run_demo"](cfg, wheel_np, device=dev,
                                              checkpoint_every=CKPT_EVERY, checkpoint_path=ckpt)
    t_res = time.perf_counter() - t0
    counts = {"B": counters["launches.B"], "A2": counters["launches.A.fresh"],
              "A1": counters["launches.A"] - counters["launches.A.fresh"]}
    d = runs_rel(s_res, s_full)
    print(f"phase8a resume 512x512 w free {DEMO_BUDGET['samples']}/{DEMO_BUDGET['warmup']}, "
          f"checkpoint every {CKPT_EVERY}, preempted before segment 2 ({done} iterations done): "
          f"resumed launches {json.dumps(counts)} (main steps left {cfg.sapg.samples - 1 - done});"
          f" max relative difference to the uninterrupted run {d:.3e} (bound {RESUME_BOUND}); "
          f"theta_EB {r_res['theta_EB']:.6f} vs {r_full['theta_EB']:.6f}; s: uninterrupted demo "
          f"{t_full:.3f}, cut run {t_cut:.3f}, resumed demo {t_res:.3f} [{tag}]", flush=True)
    check(counts["B"] == cfg.sapg.samples - 1 - done, "the resumed run launched warm-up steps")
    check(counts["A2"] == 0, "the resumed run ran the initial prox")
    check(counts["A1"] > 0, "the resumed demo's SALSA did not run kernel A1")
    check(d <= RESUME_BOUND, f"the resumed run left the uninterrupted one: {d}")
    check_demo(r_res, s_res, salsa, prob, cfg, wheel_np.shape, "8a resumed demo")

    # 8b: a NaN in X[0, 0, 0] before segment 2, with a checkpoint to restore
    guard = os.path.join(PHASE8_DIR, "guard.npz")
    delete_checkpoint(guard)
    problem, gen = demo_problem(torch, m["build_problem"], cfg, wheel_np, dev)
    fired = []
    t0 = time.perf_counter()
    s_rec = m["run_sapg"](problem, gen, checkpoint_every=CKPT_EVERY, checkpoint_path=guard,
                          fault_hook=nan_before(2, fired))
    t_rec = time.perf_counter() - t0
    code = tv_cuda.barrier_error()
    d_rec = runs_rel(s_rec, s_full)
    # and without one: the guard raises
    problem, gen = demo_problem(torch, m["build_problem"], cfg, wheel_np, dev)
    raised = None
    try:
        m["run_sapg"](problem, gen, checkpoint_every=CKPT_EVERY, fault_hook=nan_before(2, []))
    except SAPGDivergenceError as e:
        raised = str(e)
    code_after = tv_cuda.barrier_error()
    print(f"phase8b NaN in X[0,0,0] before segment 2: with a checkpoint restored and ended "
          f"{d_rec:.3e} from the clean run ({t_rec:.3f} s); without one raised "
          f"SAPGDivergenceError({raised!r}); barrier error code {code}, {code_after} [{tag}]",
          flush=True)
    check(fired == [2], "the NaN hook did not fire")
    check(d_rec <= RESUME_BOUND, f"the restored run left the clean one: {d_rec}")
    check(raised is not None, "a NaN without a checkpoint did not raise SAPGDivergenceError")
    check(code == 0 and code_after == 0, "a barrier gave up on a NaN chain")
    return s_full


def phase8_dft_resume(torch, dev, m, wheel_np, tag):
    """8c: resume through kernel D at 256² B=1 (fft_mode='dft', 300/200)."""
    from semiblind_tv_tpu_torch.runtime.checkpoint import delete_checkpoint
    from semiblind_tv_tpu_torch.runtime.profiling import counters

    fd = m["fd"]
    cfg = m["gaussian_preset"](fix_w1=False, fix_w2=False)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=300, warmup=200, burn_in=240, fft_mode="dft"))
    M, N = wheel_np.shape
    img = wheel_np[M // 4:3 * M // 4, N // 4:3 * N // 4]   # 256² of the 512² wheel
    every = 100
    ckpt = os.path.join(PHASE8_DIR, "resume_dft.npz")
    delete_checkpoint(ckpt)
    problem, gen = demo_problem(torch, m["build_problem"], cfg, img, dev)
    reset_counters(fd, m["fs"])
    full = m["run_sapg"](problem, gen)
    d_full = counters["launches.D"]
    problem, gen = demo_problem(torch, m["build_problem"], cfg, img, dev)
    done = interrupted(m["run_sapg"], problem, gen, ckpt, every, 2)
    problem, gen = demo_problem(torch, m["build_problem"], cfg, img, dev)
    reset_counters(fd, m["fs"])
    resumed = m["run_sapg"](problem, gen, checkpoint_every=every, checkpoint_path=ckpt)
    counts = {"D": counters["launches.D"], "B": counters["launches.B"]}
    d = runs_rel(resumed, full)
    print(f"phase8c resume through kernel D, 256x256 B=1 dft 300/200, checkpoint every {every}:"
          f" uninterrupted D launches {d_full}; resumed launches {json.dumps(counts)} "
          f"({done} done); max relative difference {d:.3e} (bound {RESUME_BOUND}) [{tag}]",
          flush=True)
    check(d_full == 299 + 199, "the uninterrupted dft run did not take kernel D every step")
    check(counts["D"] == 299 - done and counts["B"] == 0, "the resumed dft run's launches")
    check(d <= RESUME_BOUND, f"the resumed D run left the uninterrupted one: {d}")


def phase8_moments(torch, dev, m, wheel_np, tag):
    """8d: posterior moments at 512² B=16, 200 steps after burn-in; the
    step rate with and without them, interleaved in this call."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters
    import numpy as np

    fs = m["fs"]
    free = m["gaussian_preset"](fix_w1=False, fix_w2=False)
    cfg = dataclasses.replace(free, sapg=dataclasses.replace(
        free.sapg, samples=250, warmup=20, burn_in=50, track_posterior_moments=True))
    problem, gen = demo_problem(torch, m["build_problem"], cfg, wheel_np, dev)
    reset_counters(fs)
    t0 = time.perf_counter()
    res = m["run_sapg"](problem, gen, n_chains=16)
    dt = time.perf_counter() - t0
    mean, var = res.posterior_mean, res.posterior_var
    check(counters["launches.B"] == 19 + 249, "the moments run did not take kernel B every step")
    check(mean is not None and mean.shape == (16,) + wheel_np.shape, "posterior_mean missing")
    check(np.all(np.isfinite(mean)) and np.all(np.isfinite(var)), "non-finite moments")
    check(bool(np.all(var >= 0)), "a negative posterior variance")
    off = dataclasses.replace(problem, cfg=free)
    on = dataclasses.replace(problem, cfg=dataclasses.replace(free, sapg=dataclasses.replace(
        free.sapg, burn_in=1, track_posterior_moments=True)))
    rates = {"off": [], "on": []}
    for name, prob in (("off", off), ("on", on), ("off", off), ("on", on)):
        rates[name].append(step_rate(torch, prob, 16, None, n_steps=200, warm=10))
    cost = 1 - statistics.mean(rates["on"]) / statistics.mean(rates["off"])
    # the device time a step, all kernels (torch.profiler), without and with
    # the moments: their update's own device cost, free of the host's spread
    dev_us = {}
    for name, prob in (("off", off), ("on", on)):
        step, carry, draw = prepared_step(torch, prob, 16)
        state = [carry]

        def one():
            state[0], _ = step(state[0], 100, draw())

        dev_us[name] = device_us(torch, one, "", calls=10)
    print(f"phase8d moments 512x512 B=16, 200 steps after burn-in ({dt:.3f} s): mean "
          f"{float(mean.mean()):.4f}, std {float(np.sqrt(var).mean()):.4f} on average; step rate "
          f"without/with moments (A, B, A, B) {rates['off'][0]:.1f}, {rates['on'][0]:.1f}, "
          f"{rates['off'][1]:.1f}, {rates['on'][1]:.1f} chain-iter/s: cost {cost * 100:.2f}%; "
          f"device us a step without/with {dev_us['off']:.1f} / {dev_us['on']:.1f}: the update "
          f"{dev_us['on'] - dev_us['off']:.1f} us, {(dev_us['on'] / dev_us['off'] - 1) * 100:.2f}% "
          f"[{tag}]", flush=True)


def phase8_isotropic(torch, dev, m, wheel_np, tag):
    """8e: the isotropic family's demo at 512² (kernel B with positivity off,
    σ² pinned, θ in log scale)."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters

    fs = m["fs"]
    cfg = m["isotropic_preset"]()
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **DEMO_BUDGET))
    reset_counters(fs, m["tv_cuda"])
    results, sapg, salsa, problem = m["run_demo"](cfg, wheel_np, device=dev)
    print(f"phase8e isotropic 512x512 {DEMO_BUDGET['samples']}/{DEMO_BUDGET['warmup']}: "
          f"theta_EB {results['theta_EB']:.6f}, w_EB {results['psf_params_EB']['w']:.4f} (true "
          f"{results['true_psf_params']['w']}), mse_db {results['mse_db']:.3f} vs y "
          f"{results['mse_db_observation']:.3f}; B launches {counters['launches.B']}; SAPG "
          f"{results['sapg_time_s']:.3f} s [{tag}]", flush=True)
    check(counters["launches.B"] > 0, "the isotropic demo did not run kernel B")
    check_demo(results, sapg, salsa, problem, cfg, wheel_np.shape, "8e isotropic demo")


def phase8_fista(torch, dev, m, wheel_np, tag):
    """8f: TV-FISTA at 512² through A2 (100 iterations, tol 0), and a 64²
    solve on the card against the same solve on the CPU.  Returns A2's
    launches in the 512² solve."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters
    import numpy as np

    from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
    from semiblind_tv_tpu_torch.solvers.fista import fista_tv

    tv_cuda = m["tv_cuda"]
    cfg = m["gaussian_preset"](fix_w1=False, fix_w2=False)
    prob, _ = demo_problem(torch, m["build_problem"], cfg, wheel_np, dev)
    tau = 0.05 * float(prob.sigma_true) ** 2
    kw = dict(tau=tau, blur=prob.blur, tol=0.0)
    fista_tv(prob.y, prob.H_true, max_iter=10, **kw)
    torch.cuda.synchronize(dev)
    reset_counters(tv_cuda)
    t0 = time.perf_counter()
    res = fista_tv(prob.y, prob.H_true, max_iter=100, **kw)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    a2 = counters["launches.A.fresh"]
    check(res.n_iters == 100 and np.all(np.isfinite(res.x)), "FISTA 512² run failed")
    check(a2 == 100, f"FISTA launched A2 {a2} times in 100 iterations")

    # 64²: the same solve on the card and on the CPU.  In float32 100
    # accelerated iterations amplify rounding: on the CPU alone, y moved by
    # 1e-7 relative moves x by ~3e-5, so the float32 card-vs-CPU difference
    # is printed, and the checks hold (i) the kernel route against the plain
    # route on the card (the same transforms, float32) and (ii) the card's
    # plain route against the CPU's in float64
    c0, c1 = (v // 2 for v in wheel_np.shape)
    img64 = wheel_np[c0 - 32:c0 + 32, c1 - 32:c1 + 32]
    small, _ = demo_problem(torch, m["build_problem"], cfg, img64, dev)
    tau64 = 0.05 * float(small.sigma_true) ** 2
    kw64 = dict(tau=tau64, max_iter=100, tol=0.0)
    y, H = small.y, small.H_true
    y64, H64 = y.double(), H.to(torch.complex128)

    def blur(dtype, device):
        return BlurOperator((64, 64), cfg.psf_size, dtype, device)

    def rel_x(a, b):
        return float(np.abs(a.x - b.x).max() / np.abs(b.x).max())

    card = fista_tv(y, H, blur=small.blur, **kw64)
    card_plain = fista_tv(y, H, blur=small.blur, prox_route="plain", **kw64)
    host = fista_tv(y.cpu(), H.cpu(), blur=blur(torch.float32, "cpu"), **kw64)
    card64 = fista_tv(y64, H64, blur=blur(torch.float64, dev), prox_route="plain", **kw64)
    host64 = fista_tv(y64.cpu(), H64.cpu(), blur=blur(torch.float64, "cpu"), **kw64)
    d_route, d_64 = rel_x(card, card_plain), rel_x(card64, host64)
    print(f"phase8f FISTA 512x512 100 iterations (tol 0) through A2: {dt:.3f} s, A2 launches "
          f"{a2}, objective {res.objective[0]:.6g} -> {res.objective[-1]:.6g}; 64x64, 100 "
          f"iterations, relative differences in x: card A2 vs card plain {d_route:.3e} (bound "
          f"1e-5), card vs CPU float64 {d_64:.3e} (bound 1e-9), card vs CPU float32 "
          f"{rel_x(card, host):.3e}, CPU float32 vs float64 {rel_x(host, host64):.3e}, card "
          f"float32 vs float64 {rel_x(card, host64):.3e} [{tag}]", flush=True)
    check(d_route <= 1e-5, f"FISTA through A2 and through the plain prox disagree: {d_route}")
    check(d_64 <= 1e-9, f"FISTA on the card and on the CPU disagree in float64: {d_64}")
    return a2


def phase8_power(torch, dev, tag, size=512):
    """8g: the power iteration at 512² (float64) against max |H|²."""
    from semiblind_tv_tpu_torch.ops import lipschitz
    from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
    from semiblind_tv_tpu_torch.ops.psf import gaussian_kernel

    blur = BlurOperator((size, size), 7, torch.float64, dev)
    H = blur.otf(gaussian_kernel(7, 0.4, 0.3, dtype=torch.float64, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    val, iters = lipschitz.power_iteration(lambda x: blur.apply_adjoint(blur.apply(x, H), H),
                                           gen, (size, size), tol=1e-7, dtype=torch.float64)
    dt = time.perf_counter() - t0
    closed = float(lipschitz.max_eigenval_closed_form(H))
    r = abs(float(val) - closed) / closed
    print(f"phase8g power iteration {size}x{size} float64 tol 1e-7: {iters} iterations, "
          f"{dt:.3f} s, lambda {float(val):.9f} vs closed form {closed:.9f}: relative "
          f"{r:.3e} (bound 1e-3) [{tag}]", flush=True)
    check(r <= 1e-3, f"the power iteration is {r} from max |H|²")


def phase8_profile(torch, m, wheel_np, dev, tag):
    """8h: 5 steps of the 512² B=1 step inside profiling.trace; the Chrome
    trace names the resident kernel."""
    from semiblind_tv_tpu_torch.runtime import profiling

    cfg = m["gaussian_preset"](fix_w1=False, fix_w2=False)
    prob, _ = demo_problem(torch, m["build_problem"], cfg, wheel_np, dev)
    step, carry, draw = prepared_step(torch, prob, 1)
    carry, _ = step(carry, 2, draw())
    out = os.path.join(PHASE8_DIR, "trace")
    # a reading short of the 5 kernels is taken again (see `profiled`)
    for tries in range(1, PROFILE_TRIES + 1):
        t0 = time.perf_counter()
        with profiling.trace(out) as prof:
            for ii in range(3, 8):
                carry, _ = step(carry, ii, draw())
        dt = time.perf_counter() - t0
        with open(os.path.join(out, profiling.TRACE_FILE)) as f:
            text = f.read()
        n = text.count('"resident_step')
        if n >= 5:
            break
    dev_us = sum(e.device_time_total for e in prof.key_averages()
                 if e.key.startswith("resident_step"))
    print(f"phase8h profiling.trace of 5 steps at 512x512 B=1: {n} resident_step events in "
          f"{profiling.TRACE_FILE} ({len(text)} bytes), device {dev_us / 5:.1f} us a step in "
          f"resident_step, {dt:.3f} s with the profiler, reading {tries} [{tag}]", flush=True)
    check(n >= 5, "the exported trace does not name resident_step")


def phase8(torch, dev, m, wheel_np, tag):
    """Phase 8; returns A2's launches on the FISTA path."""
    os.makedirs(PHASE8_DIR, exist_ok=True)
    t = time.perf_counter()
    phase8_resume(torch, dev, m, wheel_np, tag)
    phase8_dft_resume(torch, dev, m, wheel_np, tag)
    phase8_moments(torch, dev, m, wheel_np, tag)
    phase8_isotropic(torch, dev, m, wheel_np, tag)
    a2 = phase8_fista(torch, dev, m, wheel_np, tag)
    phase8_power(torch, dev, tag)
    phase8_profile(torch, m, wheel_np, dev, tag)
    print(f"phase8 took {time.perf_counter() - t:.1f} s", flush=True)
    return a2

# ---------------------------------------------------------------------------
# phase 9: the solver zoo and the wavelet path — C-SALSA, CoRAL, generic
# SALSA, NESTA, SPGL1, the wavelet-L1 SAPG, the oracle sweep, circ_conv
# ---------------------------------------------------------------------------

ZOO_ITERS = 200
ZOO_BOUND = 1e-6   # kernel route against the plain route on the card, 64²


def zoo_path(torch, mods, fn):
    """Drive one path of phase 9 with every launch counter of `mods` (tv_cuda,
    fused_step_cuda, tv_blocked_cuda) set to 0 just before it: (fn(), host
    seconds ending in a device sync, its launches of A1, A2, B and the
    blocked prox)."""
    from semiblind_tv_tpu_torch.runtime.profiling import counters

    tv_cuda, fs, tb = mods
    reset_counters(tv_cuda, fs, tb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, {"A1": counters["launches.A"] - counters["launches.A.fresh"],
                     "A2": counters["launches.A.fresh"], "B": counters["launches.B"],
                     "F": counters["launches.blocked_prox"]}


def phase9_kernel_vs_plain(torch, m, wheel_np, dev, tag):
    """9a/9b at 64²: csalsa_tv through A1 and coral_tv_l1 through A2 (cold)
    and A1 (warm) against prox_route='plain' on the card, chambolle_tol=0,
    λ a device tensor; returns the largest relative difference in x."""
    import numpy as np

    c0, c1 = (v // 2 for v in wheel_np.shape)
    img = wheel_np[c0 - 32:c0 + 32, c1 - 32:c1 + 32]
    prob, _ = demo_problem(torch, m["build_problem"], m["gaussian_preset"](), img, dev)
    s2 = float(prob.sigma_true) ** 2
    runs = {
        "csalsa_tv A1": lambda route: m["csalsa_tv"](
            prob.y, prob.H_true, 0.05, 10.0, prob.blur, sigma=float(prob.sigma_true),
            max_iter=60, tol=0.0, chambolle_tol=0.0, prox_route=route),
        "coral cold A2": lambda route: m["coral_tv_l1"](
            prob.y, prob.H_true, 0.05 * s2, 1e-3 * s2, prob.blur, mu1=0.05, mu2=0.05,
            max_iter=60, tol=0.0, chambolle_tol=0.0, prox_route=route),
        "coral warm A1": lambda route: m["coral_tv_l1"](
            prob.y, prob.H_true, 0.05 * s2, 1e-3 * s2, prob.blur, mu1=0.05, mu2=0.05,
            max_iter=60, tol=0.0, chambolle_tol=0.0, tv_warm_start=True, prox_route=route),
    }
    diffs = {}
    for name, run in runs.items():
        kern, plain = run(None), run("plain")
        diffs[name] = float(np.abs(kern.x - plain.x).max() / np.abs(plain.x).max())
    print(f"phase9 64x64 kernel route vs plain route on the card (60 iterations, chambolle_tol "
          f"0), relative max|Δx|: {json.dumps(diffs)} (bound {ZOO_BOUND}, 0 expected) [{tag}]",
          flush=True)
    for name, d in diffs.items():
        check(d <= ZOO_BOUND, f"phase9 {name}: kernel and plain routes differ by {d}")


def phase9(torch, dev, m, wheel_np, tag):
    """Phase 9; returns the launches of A1, A2, B and the blocked prox (F at
    1024²) that the zoo's paths made."""
    import numpy as np

    from semiblind_tv_tpu_torch.cli import oracle_sweep, run_wavelet_l1
    from semiblind_tv_tpu_torch.metrics import metrics
    from semiblind_tv_tpu_torch.ops.spatial_conv import circ_conv, circ_corr
    from semiblind_tv_tpu_torch.solvers.csalsa import default_epsilon
    from semiblind_tv_tpu_torch.solvers.nesta import nesta
    from semiblind_tv_tpu_torch.solvers.salsa_generic import salsa
    from semiblind_tv_tpu_torch.solvers.spgl1 import spgl1_bpdn
    from semiblind_tv_tpu_torch.utils.images import synthetic_wheel

    tv_cuda = m["tv_cuda"]
    mods = (tv_cuda, m["fs"], m["tb"])
    total = {"A1": 0, "A2": 0, "B": 0, "F": 0}

    def path(fn):
        out, dt, n = zoo_path(torch, mods, fn)
        for k in total:
            total[k] += n[k]
        return out, dt, n

    t9 = time.perf_counter()
    prob, _ = demo_problem(torch, m["build_problem"], m["gaussian_preset"](), wheel_np, dev)
    y, H, blur, x_true = prob.y, prob.H_true, prob.blur, prob.x_true
    sig = float(prob.sigma_true)
    s2, d = sig ** 2, y.numel()
    y_mse = float(metrics.mse_db(x_true, y))
    size = "x".join(str(v) for v in y.shape)

    def mse(x):
        return float(metrics.mse_db(x_true, torch.as_tensor(x).to(dev)))

    # 9a: C-SALSA (TV) at the reference's ε through A1
    res, dt, n = path(lambda: m["csalsa_tv"](y, H, 0.05, 10.0, blur, sigma=sig,
                                             max_iter=ZOO_ITERS, tol=0.0))
    eps = default_epsilon(d, sig)
    crit, ma = float(res.criterion[-1]), mse(res.x)
    print(f"phase9a csalsa_tv {size} {ZOO_ITERS} iterations (µ1 0.05, µ2 10, tol 0): {dt:.3f} "
          f"s, launches {json.dumps(n)}; ‖Ax − y‖/ε {crit / eps:.7f} (bound 1 + 1e-3); mse_db "
          f"{ma:.3f} vs y's {y_mse:.3f} [{tag}]", flush=True)
    check(n["A1"] == res.n_iters == ZOO_ITERS, f"csalsa_tv launched A1 {n['A1']} times")
    check(np.all(np.isfinite(res.x)) and crit <= eps * (1 + 1e-3) and ma < y_mse,
          "csalsa_tv 512² failed its checks")

    # 9b: CoRAL (TV + L1), cold through A2 and warm through A1
    for warm in (False, True):
        res, dt, n = path(lambda: m["coral_tv_l1"](
            y, H, 0.05 * s2, 1e-3 * s2, blur, mu1=0.05, mu2=0.05, max_iter=ZOO_ITERS, tol=0.0,
            tv_warm_start=warm))
        obj, mc = res.objective, mse(res.x)
        print(f"phase9b coral_tv_l1 {'warm' if warm else 'cold'} {size} {ZOO_ITERS} "
              f"iterations: {dt:.3f} s, launches {json.dumps(n)}; objective {obj[1]:.6g} "
              f"(iteration 1) -> {obj[ZOO_ITERS // 2]:.6g} -> {obj[-1]:.6g}; mse_db {mc:.3f} vs "
              f"y's {y_mse:.3f} [{tag}]", flush=True)
        check((n["A1"], n["A2"]) == ((ZOO_ITERS, 0) if warm else (0, ZOO_ITERS)),
              f"coral_tv_l1 warm={warm} launched {n}")
        check(np.all(np.isfinite(res.x)) and obj[-1] <= obj[1] and mc < y_mse,
              f"coral_tv_l1 warm={warm} failed its checks")
    phase9_kernel_vs_plain(torch, m, wheel_np, dev, tag)

    # 9c: csalsa_tv at 1024² goes through the blocked prox (F), not A1
    big, _ = demo_problem(torch, m["build_problem"], m["gaussian_preset"](),
                          synthetic_wheel(TILED), dev)
    res, dt, n = path(lambda: m["csalsa_tv"](big.y, big.H_true, 0.05, 10.0, big.blur,
                                             sigma=float(big.sigma_true), max_iter=50, tol=0.0))
    print(f"phase9c csalsa_tv {TILED}x{TILED} 50 iterations: {dt:.3f} s, launches "
          f"{json.dumps(n)} [{tag}]", flush=True)
    check(n["F"] == 50 and n["A1"] == 0 and np.all(np.isfinite(res.x)),
          f"csalsa_tv at {TILED}² launched {n}")

    # 9d: generic SALSA (caller operators, the warm TV prox on A1), NESTA, SPGL1
    theta = 0.05
    tau, mu = theta * s2, theta * 0.1
    absH2 = H.real ** 2 + H.imag ** 2
    duals = [torch.zeros_like(y), torch.zeros_like(y)]

    def tv_prox_a1(v, t):
        f, st = tv_cuda.chambolle_prox_cuda(v, t, 10, duals=tuple(duals))
        duals[:] = [st.px, st.py]
        return f

    res, dt, n = path(lambda: salsa(
        y, lambda v: blur.irfft(H * blur.rfft(v)),
        lambda v: blur.irfft(torch.conj(H) * blur.rfft(v)),
        lambda r: blur.irfft(blur.rfft(r) / (absH2 + mu)), tau=tau, mu=mu, prox=tv_prox_a1,
        phi=m["tv_norm"], max_iter=ZOO_ITERS, tol=0.0))
    ms_ = mse(res.x)
    print(f"phase9d salsa (generic) {size} {ZOO_ITERS} iterations, TV prox on A1: {dt:.3f} s, "
          f"launches {json.dumps(n)}, mse_db {ms_:.3f} [{tag}]", flush=True)
    check(n["A1"] == ZOO_ITERS and np.all(np.isfinite(res.x)) and ms_ < y_mse,
          "generic salsa failed its checks")
    res, dt, _ = path(lambda: nesta(y, H, blur, muf=0.1, delta=np.sqrt(d) * sig, max_iter=100))
    mn = mse(res.x)
    print(f"phase9d nesta TV {size} 5 legs of ≤100: {dt:.3f} s, {res.n_iters} iterations, "
          f"mse_db {mn:.3f} [{tag}]", flush=True)
    check(np.all(np.isfinite(res.x)) and mn < y_mse, "nesta failed its checks")
    res, dt, _ = path(lambda: spgl1_bpdn(y, H, blur, sigma=np.sqrt(d) * sig, max_newton=5,
                                         inner_iter=30))
    mb = mse(res.x)
    print(f"phase9d spgl1_bpdn {size} ≤5 Newton steps of ≤30: {dt:.3f} s, {res.n_iters} "
          f"iterations in {res.n_newton} steps, ‖r‖/(σ√d) {res.resid_norm / (np.sqrt(d) * sig):.4f},"
          f" mse_db {mb:.3f} [{tag}]", flush=True)
    check(np.all(np.isfinite(res.x)) and mb < y_mse, "spgl1_bpdn failed its checks")

    # 9e: the wavelet-L1 SAPG with the reference's defaults (L 4, Haar, blur
    # 9, BSNR 30, 3000 samples), through its CLI
    wheel_path = os.path.join(HERE, "data", "images", "wheel.png")
    out, dt, _ = path(lambda: run_wavelet_l1.main(["--image", wheel_path, "--device", "cuda"]))
    print(f"phase9e run_wavelet_l1 {size} L=4 Haar blur 9 BSNR 30, {out['samples']} samples: "
          f"SAPG {out['sapg_time_s']:.3f} s, SALSA {out['salsa_time_s']:.3f} s "
          f"({out['salsa_iters']} iterations), {dt:.3f} s in all; theta_EB "
          f"{out['theta_EB']:.6g}, mse_db {out['mse_db']:.3f} vs y's "
          f"{out['mse_db_observation']:.3f} [{tag}]", flush=True)
    check(1e-3 <= out["theta_EB"] <= 1.0 and out["mse_db"] < out["mse_db_observation"],
          "run_wavelet_l1 failed its checks")

    # 9f: the oracle sweep, 5 θ without SAPG (SALSA through A1), then a short
    # SAPG leg (A2's initial prox, B a step) with its EB point
    out, dt, n = path(lambda: oracle_sweep.main(
        ["--image", wheel_path, "--no-sapg", "--grid", "5", "--device", "cuda"]))
    print(f"phase9f oracle_sweep {size} --no-sapg 5 θ: {dt:.3f} s, launches {json.dumps(n)}; "
          f"oracle θ {out['oracle_theta']:.6g} mse_db {out['oracle_mse_db']:.3f} [{tag}]",
          flush=True)
    check(n["A1"] > 0 and np.all(np.isfinite(out["mse_db_curve"])),
          "oracle_sweep failed its checks")
    out, dt, n = path(lambda: oracle_sweep.main(
        ["--image", wheel_path, "--samples", "300", "--warmup", "200", "--grid", "1",
         "--device", "cuda"]))
    print(f"phase9f oracle_sweep {size} with SAPG 300/200, 1 θ: {dt:.3f} s, launches "
          f"{json.dumps(n)}; theta_EB {out['theta_EB']:.6g} eb_mse_db {out['eb_mse_db']:.3f} "
          f"[{tag}]", flush=True)
    # B once a warm-up and a main step: (200 − 1) + (300 − 1)
    check(n["A2"] == 1 and n["B"] == 498 and n["A1"] > 0, f"oracle_sweep's SAPG launched {n}")

    # 9g: circ_conv/circ_corr against the rfft blur at 512² (7×7 Gaussian)
    k = m["gaussian_kernel"](7, 0.4, 0.3, device=dev)
    Hk = blur.otf(k)
    xs = torch.from_numpy(np.random.default_rng(9).random(tuple(y.shape)).astype(np.float32))
    xs = xs.to(dev)
    ec = rel(circ_conv(xs, k), blur.apply(xs, Hk))
    et = rel(circ_corr(xs, k), blur.apply_adjoint(xs, Hk))
    t_conv = cuda_ms(lambda: circ_conv(xs, k))
    t_fft = cuda_ms(lambda: blur.apply(xs, Hk))
    print(f"phase9g circ_conv / circ_corr vs BlurOperator apply / adjoint {size} 7x7: relative "
          f"{ec:.3e} / {et:.3e} (bound 1e-5); circ_conv {t_conv * 1e3:.1f} us, rfft path "
          f"{t_fft * 1e3:.1f} us [{tag}]", flush=True)
    check(ec <= 1e-5 and et <= 1e-5, "circ_conv/circ_corr disagree with the rfft blur")

    print(f"phase9 launches {json.dumps(total)}", flush=True)
    print(f"phase9 took {time.perf_counter() - t9:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 10: the parallel path — the ('data', 'chains') sharded SAPG with a
# rank's problems in one launch (per-chain scalars), run_sharded, two ranks
# on the card over gloo, the row-split spatial estimator, the parity sweep
# ---------------------------------------------------------------------------

PHASE10_DIR = os.path.join(HERE, "build", "phase10")   # git-ignored
P10_DEVICE = "cuda"
P10_BUDGET = dict(samples=200, warmup=100, burn_in=160)
P10_CHAINS = 4
P10_PROBLEMS = 4
P10_GLOO_STEPS = 100
TRACE_BOUND = 1e-6     # 10a/10b: traces against the single-device runs
XLAST_BOUND = 1e-5     # 10b: X_last
GLOO_BOUND = 1e-5      # 10c: θ, σ² after 100 steps, two ranks against one
SPATIAL_BOUND = 1e-5   # 10d
# 10f: each problem of the dft-mode data axis against its own run.  Kernel
# D's GEMM splits K by the launch's chain count (fused_dft_cuda.gemm_plan:
# 4 splits of the first product at 2 chains, 6 at 1), so a problem's
# products are summed in another order than in its own run: bit-equality is
# printed, not required.  The fault this holds off (D's auto rule read on
# all of a rank's chains) draws other noise and leaves X_last O(1) away.
DFT_AXIS_BOUND = 1e-3


def p10_cfg(m, **over):
    cfg = m["gaussian_preset"](fix_w1=False, fix_w2=False)
    return dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **dict(P10_BUDGET, **over)))


def traces_rel(a, b):
    """The largest relative difference of two SAPG runs' θ, σ², PSF and logπ
    traces (each over its largest magnitude)."""
    import numpy as np

    pairs = [(a.thetas, b.thetas), (a.sigma2s, b.sigma2s), (a.logPiTrace, b.logPiTrace)]
    pairs += [(a.psf_param_traces[n], b.psf_param_traces[n]) for n in b.psf_param_traces]
    return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)) for x, y in pairs)


def field_rel(a, b):
    import numpy as np

    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def bitwise(a, b):
    import numpy as np

    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("thetas", "sigma2s", "logPiTrace", "X_last"))


def phase10c_rank(rank, wheel_path, n_steps, warmup, device_type):
    """One of the two gloo ranks of 10c on the one card: 2 of the 4 chains
    of phase 10's problem; (θ, σ²) traces."""
    import torch

    from semiblind_tv_tpu_torch.parallel.mesh import make_mesh
    from semiblind_tv_tpu_torch.runtime.config import gaussian_preset
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg
    from semiblind_tv_tpu_torch.utils.images import load_image

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device(device_type))
    cfg = p10_cfg(dict(gaussian_preset=gaussian_preset), samples=n_steps + 1, warmup=warmup,
                  burn_in=n_steps // 2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    problem = build_problem(load_image(wheel_path), cfg, gen, device=dev)
    mesh = make_mesh(1, 2, device_type=device_type)
    res = run_sapg(problem, gen, n_chains=P10_CHAINS, mesh=mesh)
    return res.thetas, res.sigma2s


def phase10_chain_scalars(torch, dev, m, problems, tag):
    """Kernels B, A2 and A1 with (B,) scalars — the 16 chains of 10b's four
    problems, γ, λ and λθ₀ of each problem repeated for its chains —
    against their plain versions fed the same vectors (tol 0: bit-equal)."""
    tv_cuda, fs = m["tv_cuda"], m["fs"]
    C = P10_CHAINS
    gam = torch.stack([p.gamma for p in problems]).repeat_interleave(C)
    lam = torch.stack([p.lambda_myula for p in problems]).repeat_interleave(C)
    lt = lam * problems[0].cfg.theta.init
    X = torch.stack([p.y for p in problems]).repeat_interleave(C, dim=0).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    z = torch.randn(X.shape, generator=gen, device=dev)
    grad = torch.randn(X.shape, generator=gen, device=dev) * 0.01
    prox = X + torch.randn(X.shape, generator=gen, device=dev)
    out = {}
    kw = dict(n_sweeps=25, tol=0.0)
    k = fs.myula_prox_tv(X, prox, grad, z, gam, lam, lt, **kw)
    p = fs.myula_prox_tv_plain(X, prox, grad, z, gam, lam, lt, **kw)
    out["B"] = (max_abs(zip(k[:2], p[:2])), rel(k[2], p[2]))
    f, _ = tv_cuda.chambolle_prox_cuda(X, lt, 25, tol=0.0, return_state=False)
    pf, _ = tv_cuda.chambolle_prox_plain(X, lt, 25, tol=0.0, return_state=False)
    out["A2"] = (max_abs([(f, pf)]), 0.0)
    duals = (z * 0.1, grad * 10)
    f, st = tv_cuda.chambolle_prox_cuda(X, lam * 20, 10, tol=0.0, duals=duals)
    pf, pst = tv_cuda.chambolle_prox_plain(X, lam * 20, 10, tol=0.0, duals=duals)
    out["A1"] = (max_abs([(f, pf), (st.px, pst.px), (st.py, pst.py)]), 0.0)
    print(f"phase10b kernels with (B,) scalars, 512x512 B={X.shape[0]} (4 problems x {C} "
          f"chains), against their plain versions fed the same vectors, tol 0: max|Δ| "
          + ", ".join(f"{k_} {v[0]:.3e}" for k_, v in out.items())
          + f"; B's TV {out['B'][1]:.3e} relative; barrier error {tv_cuda.barrier_error()} "
          f"[{tag}]", flush=True)
    for k_, (d, _) in out.items():
        check(d == 0.0, f"kernel {k_} with per-chain scalars differs from its plain version")
    check(out["B"][1] <= REL_BOUND, "kernel B's TV with per-chain scalars")
    check(tv_cuda.barrier_error() == 0, "a barrier gave up with per-chain scalars")


def phase10_dft_axis(torch, dev, m, mesh, wheel_np, tag):
    """10f: the data axis in dft mode at 256² (fuse_dft auto, in_kernel_rng
    on), D=2 problems × C=1 chain on one rank: the chain-count rules read
    one problem's chains, so kernel D runs every step and no seeds are
    drawn (kernel C never launches), as in each problem's own run; each
    problem against its own run on the same noise."""
    from semiblind_tv_tpu_torch.parallel.sapg_parallel import run_sapg_sharded
    from semiblind_tv_tpu_torch.runtime.profiling import counters

    fd, fs = m["fd"], m["fs"]
    cfg = p10_cfg(m, samples=30, warmup=10, burn_in=24, fft_mode="dft", in_kernel_rng=True)
    img = wheel_np[128:384, 128:384]
    problems, gens = [], []
    for d_ in range(2):
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.seed + 20 + d_)
        problems.append(m["build_problem"](img, cfg, g, device=dev))
        gens.append(g)
    states = [g.get_state() for g in gens]
    counters.reset("launches.D", "launches.C")
    t0 = time.perf_counter()
    sharded = run_sapg_sharded(problems, mesh, gens, chains_per_shard=1)
    dt = time.perf_counter() - t0
    n_d, n_c = counters["launches.D"], counters["launches.C"]
    singles = []
    for g, st, p_ in zip(gens, states, problems):
        g.set_state(st)
        singles.append(m["run_sapg"](p_, g, n_chains=1))
    steps = (cfg.sapg.warmup - 1) + (cfg.sapg.samples - 1)
    d_tr = max(traces_rel(a, b) for a, b in zip(sharded, singles))
    d_x = max(field_rel(a.X_last, b.X_last) for a, b in zip(sharded, singles))
    same = all(bitwise(a, b) for a, b in zip(sharded, singles))
    print(f"phase10f data axis in dft mode, 256x256, 2 problems x 1 chain, fuse_dft auto, "
          f"in_kernel_rng on, {cfg.sapg.samples}/{cfg.sapg.warmup}: kernel D {n_d} launches of "
          f"2 chains ({steps} steps), kernel C {n_c}; each problem against its own run: "
          f"{'bit-equal' if same else 'not bit-equal'}, traces {d_tr:.3e}, X_last {d_x:.3e} "
          f"(bound {DFT_AXIS_BOUND}); {dt:.3f} s [{tag}]", flush=True)
    check(n_d == steps and n_c == 0,
          f"10f: the dft data axis launched D {n_d} (want {steps}) and C {n_c} (want 0) times")
    check(d_tr <= DFT_AXIS_BOUND and d_x <= DFT_AXIS_BOUND,
          "10f: a problem of the dft data axis left its own run")


SAPG_SRC = "semiblind_tv_tpu_torch/csrc/sapg_stats.cu"


def sapg_inputs(torch, dev, C, P, M=512, N=512, seed=0):
    """A 512² step's half-spectrum inputs of one problem × C chains, P
    free PSF parameters."""
    from semiblind_tv_tpu_torch.ops.fourier import rfft_weights

    g = torch.Generator(device=dev).manual_seed(seed)
    Nh = N // 2 + 1

    def cplx(shape, scale):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.complex64) * scale

    def unif(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    return dict(xhat=cplx((1, C, M, Nh), 1e3), h=cplx((M, Nh) if P == 0 else (1, M, Nh), 0.5),
                yhat=cplx((1, M, Nh), 1e3), tv=unif((1, C), 1e5, 1e6),
                theta=unif((1,), 0.005, 0.05), sigma2=unif((1,), 1.0, 20.0),
                dhs={n: cplx((1, M, Nh), 0.1) for n in ("alpha", "beta")[:P]},
                weights=rfft_weights((M, N), device=dev), dim=M * N)


def sapg_work(C, P, M=512, N=512):
    """(operations, bytes) of the residual and the statistics of C chains:
    each value of X̂ read once (and Ĝ written once), H and ŷ (and each free
    parameter's dH) read once; the residual's 14 operations a value (two
    complex products and a difference), the statistics' 13 and 11 more a
    free parameter."""
    v, one = C * M * (N // 2 + 1), M * (N // 2 + 1)
    return {"residual": (14 * v, 16 * v + 16 * one),
            "stats": ((13 + 11 * P) * v, 8 * v + (16 + 8 * P) * one)}


def phase11(torch, dev, tag):
    """Phase 11; returns {kernel: stats} for the kernel table's rows."""
    import dataclasses

    from semiblind_tv_tpu_torch.ops import sapg_stats as ss
    from semiblind_tv_tpu_torch.runtime.config import gaussian_preset, moffat_preset
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.runtime.profiling import counters
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg, sa_step_coefficients
    from semiblind_tv_tpu_torch.utils.images import load_image

    t11 = time.perf_counter()
    out = {}
    # read between calls so that each call starts with none of its inputs in L2
    evict = torch.empty((64 << 20,), dtype=torch.float32, device=dev)
    evict.fill_(1.0)

    def cold(fn):
        def call():
            evict.sum()
            return fn()
        return call

    def cold_ms(fn, reps=20, warm=3):
        """Median ms of fn() alone over `reps` CUDA-event timings, each
        after L2 is emptied."""
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            evict.sum()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    for C, P in ((1, 0), (16, 0), (1, 2)):
        a = sapg_inputs(torch, dev, C, P)
        args = (a["xhat"], a["h"], a["yhat"], a["tv"], a["theta"], a["sigma2"], a["dhs"],
                a["weights"], a["dim"])
        cfg = moffat_preset() if P else gaussian_preset()
        cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, samples=100))
        rule = ss.sa_rule(cfg, False, torch.float32, dev)
        table = torch.from_numpy(sa_step_coefficients(cfg, a["dim"])).float().to(dev)
        consts = dict(sigma2_lo=a["sigma2"] * 0.5, sigma2_hi=a["sigma2"] * 2,
                      sigma2_init=a["sigma2"])
        params = {n: torch.full((1,), 2.0, device=dev) for n in rule.free_names}
        index = torch.tensor([9], device=dev)
        ws = {}   # the statistics' buffers, made once as the step makes them
        packed = ss.sapg_stats(*args, workspace=ws)
        calls = {
            "residual": (lambda: ss.sapg_residual(a["xhat"], a["h"], a["yhat"]),
                         lambda: ss.sapg_residual_plain(a["xhat"], a["h"], a["yhat"])),
            "stats": (lambda: ss.sapg_stats(*args, workspace=ws),
                      lambda: ss.sapg_stats_plain(*args)),
            "update": (lambda: ss.sapg_update(packed, 1, table, index, a["theta"], a["sigma2"],
                                              params, consts, rule),
                       lambda: ss.sapg_update_plain(
                           dict(zip(ss.stat_names(rule.free_names), packed.unbind(0))),
                           ss.coefficient_column(table, index), a["theta"], a["sigma2"],
                           params, consts, rule)),
        }
        stat_plain = torch.stack(list(ss.sapg_stats_plain(*args).values()))
        # every statistic within 1e-5 of the float64 magnitude of its terms
        errs = {"residual": rel(calls["residual"][0](), calls["residual"][1]()),
                "stats": float(((packed - stat_plain).double().abs()
                                / ss.stat_scales(*args)).max()),
                "update": float(((calls["update"][0]() - calls["update"][1]()).abs()
                                 / calls["update"][1]().abs().clamp_min(1e-30)).max())}
        work = sapg_work(C, P)
        for k, (kern, plain) in calls.items():
            ms, plain_ms = cold_ms(kern), cold_ms(plain)
            dev_us = device_us(torch, cold(kern), f"sapg_{k}")
            w = work.get(k, (0.0, 0.0))
            b = bound(w) if k in work else {"bound_ms": 0.0, "bound_by": "latency"}
            print(f"phase11 sapg_{k} 512x512 B={C} P={P} (L2 emptied before each call): "
                  f"kernel {ms * 1e3:.1f} us (device {dev_us:.1f} us), plain "
                  f"{plain_ms * 1e3:.1f} us, bound {b['bound_ms'] * 1e3:.2f} us "
                  f"({b['bound_by']}), max error {errs[k]:.2e} [{tag}]", flush=True)
            if (C, P) == (1, 0):
                out[k] = dict(max_abs_err=errs[k], ms=ms, plain_ms=plain_ms, work=w,
                              device_us=dev_us)
        check(errs["residual"] <= 1e-6 and errs["stats"] <= 1e-5 and errs["update"] <= 1e-6,
              f"phase11 kernels left their plain versions at B={C} P={P}: {errs}")

    # the launches of a short run on the main path
    cfg = gaussian_preset()
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, samples=20, warmup=40,
                                                            burn_in=16))
    gen = torch.Generator(device=dev).manual_seed(2)
    problem = build_problem(load_image(os.path.join(HERE, "data", "images", "wheel.png")), cfg,
                            gen, device=dev)
    names = ("launches.sapg_residual", "launches.sapg_stats", "launches.sapg_update")
    counters.reset(*names)
    run_sapg(problem, gen)
    got = [counters[n] for n in names]
    steps = (cfg.sapg.warmup - 1) + (cfg.sapg.samples - 1)
    print(f"phase11 run_sapg 512x512 B=1 {cfg.sapg.samples}/{cfg.sapg.warmup}: launches "
          f"{dict(zip(names, got))} [{tag}]", flush=True)
    check(got == [steps, steps + 1, cfg.sapg.samples - 1], f"phase11 launches {got}")
    for k, n in zip(("residual", "stats", "update"), got):
        out[k]["launches"] = n
    print(f"phase11 took {time.perf_counter() - t11:.1f} s", flush=True)
    return out


def phase10(torch, dev, m, wheel_np, tag):
    """Phase 10; returns the launches of A1, A2 and B its paths made."""
    import numpy as np

    from semiblind_tv_tpu_torch.benchmarks import run_reference_images
    from semiblind_tv_tpu_torch.cli import run_sharded
    from semiblind_tv_tpu_torch.parallel import spatial
    from semiblind_tv_tpu_torch.parallel.mesh import make_mesh, make_spatial_mesh
    from semiblind_tv_tpu_torch.parallel.sapg_parallel import run_sapg_sharded
    from semiblind_tv_tpu_torch.runtime.distributed import initialize, spawn
    from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv

    mods = (m["tv_cuda"], m["fs"], m["tb"])
    total = {"A1": 0, "A2": 0, "B": 0}

    def path(fn):
        out, dt, n = zoo_path(torch, mods, fn)
        for k in total:
            total[k] += n[k]
        return out, dt, n

    t10 = time.perf_counter()
    os.makedirs(PHASE10_DIR, exist_ok=True)
    wheel_path = os.path.join(HERE, "data", "images", "wheel.png")
    cfg = p10_cfg(m)
    steps = (cfg.sapg.warmup - 1) + (cfg.sapg.samples - 1)

    # 10a: a one-process NCCL world, a 1x1 mesh, against run_sapg
    t0 = time.perf_counter()
    initialize(P10_DEVICE)
    mesh = make_mesh(1, 1, device_type=P10_DEVICE)
    t_init = time.perf_counter() - t0
    prob, gen = demo_problem(torch, m["build_problem"], cfg, wheel_np, dev)
    state = gen.get_state()
    res_a, dt_a, n_a = path(lambda: m["run_sapg"](prob, gen, n_chains=P10_CHAINS, mesh=mesh))
    gen.set_state(state)
    ref_a = m["run_sapg"](prob, gen, n_chains=P10_CHAINS)
    d_a = max(traces_rel(res_a, ref_a), field_rel(res_a.X_last, ref_a.X_last))
    same = bitwise(res_a, ref_a)
    print(f"phase10a run_sapg(mesh=1x1 NCCL) 512x512 w free {cfg.sapg.samples}/"
          f"{cfg.sapg.warmup}, {P10_CHAINS} chains: launches {json.dumps(n_a)}; against "
          f"run_sapg(n_chains={P10_CHAINS}) on the same generator: "
          f"{'bit-equal' if same else f'max relative {d_a:.3e}'} (bound {TRACE_BOUND}); "
          f"{dt_a:.3f} s vs {ref_a.exec_time:.3f} s; world and mesh set up in {t_init:.3f} s "
          f"[{tag}]", flush=True)
    check(n_a["A2"] == 1 and n_a["B"] == steps, f"10a launched {n_a}")
    check(d_a <= TRACE_BOUND, f"10a left the single-device run: {d_a}")

    # 10b: D=4 problems x C=4 chains in one world: one B launch of 16 chains
    # a step, through run_sharded, then each problem against its own run
    argv = ["--problems", str(P10_PROBLEMS), "--chains-per-shard", str(P10_CHAINS),
            "--no-fix-w", "--samples", str(cfg.sapg.samples), "--warmup", str(cfg.sapg.warmup),
            "--image", wheel_path, "--size", "512", "--device", P10_DEVICE]
    out, dt_b, n_b = path(lambda: run_sharded.main(argv))
    check(n_b["B"] == steps and n_b["A2"] == 1 and n_b["A1"] > 0,
          f"run_sharded launched {n_b} (one B a step for all {P10_PROBLEMS * P10_CHAINS} chains)")
    sig = [float(v) for v in np.asarray([e["sigma2_EB"] for e in out["problems"]])]
    gens = []
    problems = []
    for d_ in range(P10_PROBLEMS):
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.seed + d_)
        problems.append(m["build_problem"](wheel_np, cfg, g, device=dev))
        gens.append(g)
    states = [g.get_state() for g in gens]
    sharded = run_sapg_sharded(problems, mesh, gens, chains_per_shard=P10_CHAINS)
    singles = []
    for g, st, p_ in zip(gens, states, problems):
        g.set_state(st)
        singles.append(m["run_sapg"](p_, g, n_chains=P10_CHAINS))
    d_tr = max(traces_rel(a, b) for a, b in zip(sharded, singles))
    d_x = max(field_rel(a.X_last, b.X_last) for a, b in zip(sharded, singles))
    same_b = all(bitwise(a, b) for a, b in zip(sharded, singles))
    r16 = P10_PROBLEMS * P10_CHAINS * steps / sharded[0].exec_time
    r4 = P10_PROBLEMS * P10_CHAINS * steps / sum(s_.exec_time for s_ in singles)
    for d_, e in enumerate(out["problems"]):
        s_lo, s_hi = (float(v) for v in problems[d_].sigma2_box)
        check(cfg.theta.box[0] <= e["theta_EB"] <= cfg.theta.box[1]
              and s_lo <= e["sigma2_EB"] <= s_hi
              and all(s_.box[0] <= e["psf_params_EB"][s_.name] <= s_.box[1]
                      for s_ in cfg.psf_params)
              and e["mse_db"] < e["mse_db_observation"],
              f"10b problem {d_} failed check_demo's rules: {e}")
        check(abs(e["theta_EB"] - sharded[d_].theta_EB) <= TRACE_BOUND * sharded[d_].theta_EB,
              f"10b: the CLI's problem {d_} differs from run_sapg_sharded's")
    print(f"phase10b run_sharded --problems {P10_PROBLEMS} --chains-per-shard {P10_CHAINS} "
          f"512x512 w free: {dt_b:.3f} s (SAPG {out['sapg_wall_s']:.3f} s), launches "
          f"{json.dumps(n_b)}; theta_EB {[round(e['theta_EB'], 6) for e in out['problems']]}, "
          f"sigma2_EB {[round(v, 4) for v in sig]}, mse_db "
          f"{[round(e['mse_db'], 3) for e in out['problems']]} vs y's "
          f"{[round(e['mse_db_observation'], 3) for e in out['problems']]}; each problem against "
          f"its own run on the same noise: {'bit-equal' if same_b else 'not bit-equal'}, traces "
          f"{d_tr:.3e} (bound {TRACE_BOUND}), X_last {d_x:.3e} (bound {XLAST_BOUND}); "
          f"chain-iter/s: 16 chains in one launch {r16:.1f}, 4 single-problem runs {r4:.1f} "
          f"[{tag}]", flush=True)
    check(d_tr <= TRACE_BOUND and d_x <= XLAST_BOUND, "10b left the single-problem runs")
    phase10_chain_scalars(torch, dev, m, problems, tag)

    # 10c: two processes on the one card over gloo, 2 of 4 chains each
    n_c = P10_GLOO_STEPS
    t0 = time.perf_counter()
    th_c, s2_c = spawn(phase10c_rank, 2, (wheel_path, n_c, cfg.sapg.warmup, P10_DEVICE),
                       device_type=P10_DEVICE, backend="gloo", timeout=300)[0]
    dt_c = time.perf_counter() - t0
    d_c = max(field_rel(th_c, res_a.thetas[:n_c + 1]), field_rel(s2_c, res_a.sigma2s[:n_c + 1]))
    print(f"phase10c two ranks on one card over gloo (2 of {P10_CHAINS} chains each), "
          f"{cfg.sapg.warmup} warm-up + {n_c} steps: θ and σ² traces against 10a's one rank, "
          f"max relative {d_c:.3e} (bound {GLOO_BOUND}); {dt_c:.3f} s with both processes' "
          f"start [{tag}]", flush=True)
    check(d_c <= GLOO_BOUND, f"10c: two ranks left one: {d_c}")

    # 10d: the row-split estimator and SALSA in a one-rank 'space' world
    smesh = make_spatial_mesh(1, device_type=P10_DEVICE)
    cfg_d = p10_cfg(m, samples=60, warmup=30, burn_in=48, fft_mode="dft")
    prob_d, gen_d = demo_problem(torch, m["build_problem"], cfg_d, wheel_np, dev)
    st = gen_d.get_state()
    t0 = time.perf_counter()
    sp = spatial.run_sapg_spatial(prob_d, smesh, gen_d)
    dt_sp = time.perf_counter() - t0
    gen_d.set_state(st)
    ref_d = m["run_sapg"](prob_d, gen_d, n_chains=1, route="plain")
    d_d = max(traces_rel(sp, ref_d), field_rel(sp.X_last, ref_d.X_last))
    theta, s2 = 0.05, float(prob_d.sigma_true) ** 2
    kw = dict(max_iter=60, tol=0.0, tv_iters=10)
    t0 = time.perf_counter()
    x_sp, objs, n_sp = spatial.spatial_salsa_tv(prob_d.y, prob_d.H_true, theta * s2, theta * 0.1,
                                                smesh, **kw)
    dt_ss = time.perf_counter() - t0
    ref_s = salsa_tv(prob_d.y, prob_d.H_true, theta * s2, theta * 0.1, prob_d.blur,
                     prox_route="plain", **kw)
    d_s = max(field_rel(x_sp.cpu().numpy(), ref_s.x), field_rel(objs, ref_s.objective[1:]))
    print(f"phase10d run_sapg_spatial (1 rank, 60/30, dft) against run_sapg route plain: max "
          f"relative {d_d:.3e}; spatial_salsa_tv (60 iterations, tol 0) against salsa_tv route "
          f"plain: {d_s:.3e} (bound {SPATIAL_BOUND}); {dt_sp:.3f} s / {dt_ss:.3f} s [{tag}]",
          flush=True)
    check(d_d <= SPATIAL_BOUND and d_s <= SPATIAL_BOUND and n_sp == 60,
          "10d: the spatial path left the single-device one")

    # 10f: the data axis in dft mode, kernel D's chain-count rule
    phase10_dft_axis(torch, dev, m, mesh, wheel_np, tag)

    # 10e: the parity sweep over two photographs
    outdir = os.path.join(PHASE10_DIR, "parity")
    (agg, per), dt_e, n_e = path(lambda: run_reference_images.main(
        ["--images", "wheel,boat", "--samples", "64", "--warmup", "32", "--device", P10_DEVICE,
         "--out", outdir]))
    print(f"phase10e run_reference_images wheel, boat 512x512 64/32 samples: {dt_e:.3f} s, "
          f"launches {json.dumps(n_e)}; run_stats {json.dumps(agg)}; mse_db "
          f"{[round(r['mse_db'], 3) for r in per.values()]} vs y's "
          f"{[round(r['mse_db_observation'], 3) for r in per.values()]} [{tag}]", flush=True)
    check(agg["count"] == 2.0 and np.isfinite(agg["mse_avg"]) and n_e["B"] > 0,
          "10e: the parity sweep failed its checks")
    print(f"phase10 launches {json.dumps(total)}", flush=True)
    print(f"phase10 took {time.perf_counter() - t10:.1f} s", flush=True)
    torch.distributed.destroy_process_group()   # 10a's one-process world
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1
    import numpy as np

    from semiblind_tv_tpu_torch import _build
    from semiblind_tv_tpu_torch.benchmarks import probe_prox_variants as pv
    from semiblind_tv_tpu_torch.cli.run_demo import run_demo
    from semiblind_tv_tpu_torch.ops import fused_dft_cuda as fd
    from semiblind_tv_tpu_torch.ops import fused_step_cuda, tv_cuda
    from semiblind_tv_tpu_torch.ops import tv_blocked_cuda as tb
    from semiblind_tv_tpu_torch.runtime.config import (
        gaussian_preset,
        isotropic_preset,
        laplace_preset,
        moffat_preset,
    )
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.runtime.profiling import counters
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg
    from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv
    from semiblind_tv_tpu_torch.utils.images import load_image

    t_start = time.perf_counter()
    # ---- phase 0 ------------------------------------------------------------
    card = pv.card_line()
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
    sources = ", ".join(os.path.relpath(s, HERE) for s in _build.SOURCES)
    print(f"phase1 kernels built from {sources}: {built}, "
          f"load {time.perf_counter() - t0:.2f} s", flush=True)
    # ptxas: registers, shared memory and spills of every kernel
    for line in _build.BUILD_LOG.splitlines():
        if "Used" in line or "spill" in line:
            print("phase1   " + line.strip(), flush=True)

    wheel_np = load_image(os.path.join(HERE, "data", "images", "wheel.png"))
    if "--phase11" in sys.argv[1:]:
        phase11(torch, dev, tag)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--phase10" in sys.argv[1:]:
        # phase 10 by itself (after phases 0 and 1)
        phase10(torch, dev, dict(fs=fused_step_cuda, fd=fd, tv_cuda=tv_cuda, tb=tb,
                                 run_sapg=run_sapg, build_problem=build_problem,
                                 gaussian_preset=gaussian_preset),
                wheel_np, tag)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # ---- phase 2 ------------------------------------------------------------
    wheel = torch.from_numpy(wheel_np.astype(np.float32)).to(dev)
    stats = phase2(torch, dev, tv_cuda, fused_step_cuda, wheel, tag)
    resident_design(torch, dev, tv_cuda, fused_step_cuda, _build, wheel, tag)

    # ---- phase 3 ------------------------------------------------------------
    cfg = gaussian_preset()
    cfg = dataclasses.replace(
        cfg, sapg=dataclasses.replace(cfg.sapg, samples=2000, warmup=1500, burn_in=1600)
    )
    counters.reset("launches.A", "launches.A.fresh", "launches.B", "launches.blocked_step",
                   "launches.blocked_prox", "launches.blocked_prox.fresh")
    results, sapg, salsa, problem = run_demo(cfg, wheel_np, n_chains=1, device="cuda")
    launches = {"A1": counters["launches.A"] - counters["launches.A.fresh"],
                "A2": counters["launches.A.fresh"], "B": counters["launches.B"]}
    print("phase3 results " + json.dumps(results), flush=True)
    print(f"phase3 launches {json.dumps(launches)}; blocked "
          f"{counters['launches.blocked_prox'] + counters['launches.blocked_step']}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    check_demo(results, sapg, salsa, problem, cfg, (512, 512), "512² demo")

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
        rp = step_rate(torch, prob, B, "plain", n_steps=50, warm=5)
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
    print(f"phase0-4 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 5 ------------------------------------------------------------
    t5 = time.perf_counter()
    big_stats = phase5_kernels(torch, dev, tv_cuda, fused_step_cuda, tb, wheel, tag)
    phase5_design(torch, dev, tb, tv_cuda, _build, wheel, tag)
    big_launches = phase5_demos(torch, tv_cuda, fused_step_cuda, tb, run_demo,
                                (gaussian_preset, laplace_preset, moffat_preset), tag)
    phase5_card_vs_plain(torch, dev, run_demo, gaussian_preset, tag)
    phase5_rates(torch, dev, build_problem, gaussian_preset, salsa_tv, tag)
    for k, s in big_stats.items():
        print(f"phase5 row {k}: blocked {s['ms'] * 1e3:.1f} us, plain "
              f"{s['plain_ms'] * 1e3:.1f} us, resident kernel {s['resident_ms'] * 1e3:.1f} us "
              f"at B=1 [{tag}]", flush=True)
    print(f"phase5 took {time.perf_counter() - t5:.1f} s", flush=True)

    # ---- phase 6 ------------------------------------------------------------
    t6 = time.perf_counter()
    # the plain DFT transforms and D's float64 reference run on torch.matmul
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest", "TF32 is on for matmuls")
    big = wheel.repeat(STREAMED // wheel.shape[0], STREAMED // wheel.shape[1])
    noise_stats = phase6_noise_kernels(torch, dev, fused_step_cuda, big, tag)
    dft_stats = phase6_dft_kernels(torch, dev, fused_step_cuda, fd, tv_cuda, big, tag)
    new_launches = phase6_demos(torch, fused_step_cuda, fd, tv_cuda, tb, run_demo,
                                gaussian_preset, wheel_np, tag)
    phase6_card_vs_plain(torch, dev, fd, run_demo, gaussian_preset, wheel_np, tag)
    phase6_rates(torch, dev, build_problem, gaussian_preset, wheel_np, tag)
    new_stats = dict(noise_stats, **dft_stats)
    print(f"phase6 took {time.perf_counter() - t6:.1f} s", flush=True)

    # ---- phase 7 ------------------------------------------------------------
    t7 = time.perf_counter()
    j_stats = {"J": phase7_kernels(torch, dev, pv, tv_cuda, _build, tag)}
    j_launches = phase7_probe(torch, dev, pv, tv_cuda, tag)
    print(f"phase7 took {time.perf_counter() - t7:.1f} s", flush=True)

    # ---- phase 8 ------------------------------------------------------------
    mods = dict(fs=fused_step_cuda, fd=fd, tv_cuda=tv_cuda, run_demo=run_demo,
                run_sapg=run_sapg, build_problem=build_problem,
                gaussian_preset=gaussian_preset, isotropic_preset=isotropic_preset)
    # A2's row counts its launches on the main path and on FISTA's
    launches["A2"] += phase8(torch, dev, mods, wheel_np, tag)

    # ---- phase 9 ------------------------------------------------------------
    from semiblind_tv_tpu_torch.ops.psf import gaussian_kernel
    from semiblind_tv_tpu_torch.ops.tv import tv_norm
    from semiblind_tv_tpu_torch.solvers.coral import coral_tv_l1
    from semiblind_tv_tpu_torch.solvers.csalsa import csalsa_tv

    mods.update(tb=tb, csalsa_tv=csalsa_tv, coral_tv_l1=coral_tv_l1, tv_norm=tv_norm,
                gaussian_kernel=gaussian_kernel)
    zoo = phase9(torch, dev, mods, wheel_np, tag)
    # A1, A2 and B count the zoo's paths too, F its 1024² C-SALSA
    for k in ("A1", "A2", "B"):
        launches[k] += zoo[k]
    big_launches["F"] += zoo["F"]

    # ---- phase 10 -----------------------------------------------------------
    par = phase10(torch, dev, mods, wheel_np, tag)
    for k in ("A1", "A2", "B"):
        launches[k] += par[k]

    # ---- phase 11 -----------------------------------------------------------
    sapg_stats = phase11(torch, dev, tag)
    sapg_launches = {k: v["launches"] for k, v in sapg_stats.items()}

    src = KERNELS_SRC
    rows = [
        ("chambolle_prox_cuda[warm]", src, "semiblind_tv_tpu/ops/tv_pallas.py:262", "A1",
         stats, launches),
        ("chambolle_prox_cuda[fresh]", src, "semiblind_tv_tpu/ops/tv_pallas.py:232", "A2",
         stats, launches),
        ("myula_prox_tv", src, "semiblind_tv_tpu/ops/fused_step_pallas.py:375", "B",
         stats, launches),
        ("chambolle_prox_blocked[1024²]", BLOCKED_SRC,
         "semiblind_tv_tpu/ops/tv_pallas.py:560", "F", big_stats, big_launches),
        ("myula_prox_tv_blocked[1024²]", BLOCKED_SRC,
         "semiblind_tv_tpu/ops/fused_step_pallas.py:780", "G", big_stats, big_launches),
        ("chambolle_prox_blocked[2048²]", BLOCKED_SRC,
         "semiblind_tv_tpu/ops/tv_pallas.py:1180", "H", big_stats, big_launches),
        ("myula_prox_tv_blocked[2048²]", BLOCKED_SRC,
         "semiblind_tv_tpu/ops/fused_step_pallas.py:528", "I", big_stats, big_launches),
        ("myula_prox_tv_blocked[seeds, 2048²]", BLOCKED_SRC,
         "semiblind_tv_tpu/ops/tv_pallas.py:1180", "I[seeds]", new_stats, new_launches),
        ("myula_prox_tv_rng", src, "semiblind_tv_tpu/ops/fused_step_pallas.py:166", "C",
         new_stats, new_launches),
        ("myula_prox_tv_dft", DFT_SRC, "semiblind_tv_tpu/ops/fused_step_pallas.py:304", "D",
         new_stats, new_launches),
        ("myula_prox_tv_irdft", DFT_SRC, "semiblind_tv_tpu/ops/fused_step_pallas.py:496", "E",
         new_stats, new_launches),
        ("prox_variant[base]", J_SRC, "benchmarks/probe_prox_variants.py:362", "J",
         j_stats, j_launches),
        ("sapg_residual", SAPG_SRC, None, "residual", sapg_stats, sapg_launches),
        ("sapg_stats", SAPG_SRC, None, "stats", sapg_stats, sapg_launches),
        ("sapg_update", SAPG_SRC, None, "update", sapg_stats, sapg_launches),
    ]
    kernels = []
    for n, s, r, k, st, ln in rows:
        check(ln[k] > 0, f"kernel {k} was not launched on its path")
        kernels.append(dict(name=n, route="cuda", source=s, replaces=r, launches=ln[k],
                            max_abs_err=st[k]["max_abs_err"], ms=st[k]["ms"],
                            plain_ms=st[k]["plain_ms"], **bound(st[k]["work"]),
                            library_ms=st[k].get("library_ms"),
                            **{p: st[k][p] for p in ("products_ms", "products_bound_ms",
                                                     "products_bound_by") if p in st[k]}))
        print(f"row {k}: kernel {st[k]['ms'] * 1e3:.1f} us, bound {kernels[-1]['bound_ms'] * 1e3:.2f}"
              f" us ({kernels[-1]['bound_by']}; {st[k]['work'][0]:.4g} operations, "
              f"{st[k]['work'][1]:.4g} bytes), launches {ln[k]} [{tag}]", flush=True)
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
