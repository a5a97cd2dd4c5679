"""Generic SAPG estimator (port of `semiblind_tv_tpu/sapg/estimator.py`).

Algorithm (reference SAPG_algorithm_Guassian.m):
  warm-up:  `warmup` MYULA steps at fixed hyperparameters          (:67-93)
  main:     for ii = 2..samples
              X ← MYULA step (prox carried from previous iter)      (:158-162)
              G_θ = d/θ − TV(X);     θ ← clip(θ + c_θ δ(ii) G_θ)    (:165-167)
              G_p = ⟨∂_p A X, AX−y⟩/σ²;  p ← clip(p − c_p δ(ii) G_p) (:170-185)
              G_σ = ‖AX−y‖²/2σ⁴ − d/2σ²; σ² ← clip(σ² + c_σ δ(ii) G_σ) (:188-194)
            δ(ii) = d_scale · ii^(−d_exp) / d                        (:55)
  EB estimates = mean of iterates over [burnIn, samples]             (:258-290)

Per iteration: one rfft2 and one irfft2 (the scan carries rfft2(X)), the
hyper-gradients by Parseval on the half-spectrum, the OTFs of the PSF and
its free-parameter gradients by small matmuls (hoisted out of the loop when
every PSF parameter is fixed), and the spatial segment — MYULA update,
25-sweep Chambolle prox, TV norm — through the kernel that
`resolve_step_route` picks for the image size: kernel B
(ops/fused_step_cuda.myula_prox_tv) up to 512², the blocked kernel
(myula_prox_tv_blocked) above, in the form of the JAX package's tiled
kernel G up to 1024² and of its streamed kernel I beyond (gradF's /σ² in
the kernel).  `resolve_prox_route` picks the initial (and unfused) prox
the same way.  On the CPU both take the plain versions.

In fft_mode='dft' (BlurOperator's dense-DFT transforms) the step follows
the JAX package's branch order on route B: `resolve_fuse_dft` selects the
whole-iteration kernel D (ops/fused_dft_cuda.myula_prox_tv_dft: the
inverse transform, the spatial segment and the forward transform), and
`fuse_irdft` kernel E (D without the forward transform; the warm-up keeps
kernel B, as in JAX).  `resolve_in_kernel_rng` selects the in-kernel-noise
forms: kernel C (myula_prox_tv_rng) on route B and the blocked kernel's
seeds form on route I; the step then takes (B, 2) int32 seeds instead of a
noise field.

Options ported from the JAX package: sigma_log_scale, psf_log_scale and
theta_log_scale (Algorithm-1: SA updates in log space, clipped there; the
θ EB estimate is then the geometric mean of the window), fft_mode,
fuse_dft, fuse_irdft, in_kernel_rng and track_posterior_moments (Welford's
running posterior mean and variance of the post-burn-in samples, updated
in place from the step's new sample, so on every kernel route).

Checkpoint and resume (run_sapg's checkpoint_every/checkpoint_path): the
main scan runs in segments of checkpoint_every iterations and
the carry, the traces so far, the warm-up trace and the state of the
torch.Generator that draws the noise are saved after each one; a run that
finds a checkpoint at checkpoint_path skips the warm-up and resumes there,
on the same trajectory as an uninterrupted run.  A segment whose traces go
non-finite is rerun from the last checkpoint (run_segmented_scan).

Chains live on the leading dimension; the per-chain SA statistics are
averaged before the hyperparameter update.  `run_sapg(mesh=)` and
parallel/sapg_parallel.py run the problem-batched form of the same step
(make_general_sapg_step(problems=D, chains_group=...)) on each rank of a
('data', 'chains') mesh.  θ, σ² and the PSF parameters
are 0-d device tensors, the SA updates use torch.clamp, and the scalar
traces go into preallocated device tensors that are copied to the host
once, after the loop: nothing inside the loop waits for the device.

The noise source is injectable: `noise(shape) -> (B, M, N) tensor` is
called once per warm-up and main step, in that order; the default draws
standard normals from the estimator's torch.Generator.  With in-kernel
noise the seed source `seeds(B) -> (B, 2) int32 tensor` is called instead
(default: `generator_seeds`, the counterpart of the JAX chain_seeds).  Its
noise realisation differs from the default's, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from semiblind_tv_tpu_torch.ops.fused_dft_cuda import myula_prox_tv_dft, myula_prox_tv_irdft
from semiblind_tv_tpu_torch.ops.fused_step_cuda import (
    myula_prox_tv,
    myula_prox_tv_blocked,
    myula_prox_tv_plain,
    myula_prox_tv_rng,
)
from semiblind_tv_tpu_torch.ops.tv import tv_norm
from semiblind_tv_tpu_torch.ops.tv_blocked_cuda import blocked_rung, chambolle_prox_blocked
from semiblind_tv_tpu_torch.ops.tv_cuda import chambolle_prox_cuda, chambolle_prox_plain, per_chain
from semiblind_tv_tpu_torch.runtime.checkpoint import load_checkpoint_arrays, save_checkpoint_arrays
from semiblind_tv_tpu_torch.runtime.problem import Problem
from semiblind_tv_tpu_torch.samplers.myula import myula_kernel_step

__all__ = [
    "SAPGResult",
    "SAPGDivergenceError",
    "run_sapg",
    "make_sapg_step",
    "make_general_sapg_step",
    "problem_consts",
    "run_segmented_scan",
    "assemble_result",
    "generator_noise",
    "generator_seeds",
    "resolve_step_route",
    "resolve_prox_route",
    "FRESH_PROX",
    "resolve_fuse_dft",
    "resolve_in_kernel_rng",
]


class SAPGDivergenceError(RuntimeError):
    """Raised when the main scan produced non-finite traces (a diverged
    chain or a hardware fault)."""


@dataclasses.dataclass
class SAPGResult:
    """Mirror of the reference `results` struct (SAPG_algorithm_Guassian.m:250-306)."""

    theta_EB: float
    sigma2_EB: float
    psf_params_EB: Dict[str, float]
    thetas: np.ndarray
    sigma2s: np.ndarray
    psf_param_traces: Dict[str, np.ndarray]
    logPiTrace: np.ndarray          # logPiTraceX
    logPiTrace_warmup: np.ndarray   # logPiTrace_WU
    gX: np.ndarray                  # regulariser trace (shifted like the reference)
    grad_theta: np.ndarray
    grad_sigma: np.ndarray
    grad_psf: Dict[str, np.ndarray]
    mean_thetas: np.ndarray
    mean_sigma2s: np.ndarray
    mean_psf: Dict[str, np.ndarray]
    tol_thetas: np.ndarray
    tol_sigma2s: np.ndarray
    tol_psf: Dict[str, np.ndarray]
    err_psf: np.ndarray
    X_last: np.ndarray              # (n_chains, M, N)
    last_samp: int
    exec_time: float
    posterior_mean: Optional[np.ndarray] = None  # Welford over post-burn-in
    posterior_var: Optional[np.ndarray] = None   # samples (per chain)

    @property
    def last_theta(self):
        return float(self.thetas[-1])


def _running_window_stats(trace: np.ndarray, burn_in: int, log_scale: bool = False):
    """Running means over [burnIn, ii] and their relative-change tolerances.

    trace is 0-based with trace[0] the init (MATLAB index 1).  Returns
    (mean_trace, tol_trace, eb) with mean_trace of length len-burn_in and
    tol_trace of length len (zeros before the window has two entries).
    log_scale: average log(trace) and exponentiate — the Algorithm-1 EB
    estimate exp(mean(eta)) (SALSA/SAPG_algorithm_1.m:227)."""
    n = len(trace)
    window = np.log(trace[burn_in - 1:]) if log_scale else trace[burn_in - 1:]
    running = np.cumsum(window) / np.arange(1, len(window) + 1)
    if log_scale:
        running = np.exp(running)
    eb = float(running[-1])
    mean_trace = running[1:]
    tol = np.zeros(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(running[1:] - running[:-1]) / running[:-1]
    tol[burn_in:] = rel
    return mean_trace, tol, eb


def generator_noise(generator: torch.Generator, dtype, device) -> Callable:
    """The default noise source: standard normals from `generator`."""
    def draw(shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return draw


def generator_seeds(generator: torch.Generator, device) -> Callable:
    """The default seed source of the in-kernel noise: (B, 2) int32 seed
    pairs drawn uniformly from `generator` on `device`, fresh every step
    (the counterpart of the JAX chain_seeds; no host sync)."""
    def draw(n_chains):
        return torch.randint(-2 ** 31, 2 ** 31, (n_chains, 2), generator=generator,
                             dtype=torch.int32, device=device)
    return draw


def resolve_step_route(shape, device) -> str:
    """The spatial segment's kernel for an (M, N) image on `device`, by
    the JAX package's size ladder (resolve_use_fused / resolve_use_tiled_fused
    / resolve_use_streamed_fused): 'B' up to 512² (myula_prox_tv), 'G' up
    to 1024² pixels and 'I' above (both myula_prox_tv_blocked; 'I' takes
    the raw irfft and σ², as myula_prox_tv_streamed is called); 'plain' on
    the CPU.  Launches nothing."""
    if torch.device(device).type != "cuda":
        return "plain"
    return {None: "B", "tiled": "G", "streamed": "I"}[blocked_rung(shape)]


def resolve_prox_route(shape, device) -> str:
    """The fresh-dual prox for an (M, N) image on `device` (the initial
    SAPG prox, and the step's prox when use_fused_step is False), by the
    ladder of the JAX package's prox_b: 'A2' up to 512²
    (chambolle_prox_cuda), 'F' up to 1024² pixels and 'H' above (both
    chambolle_prox_blocked); 'plain' on the CPU.  Launches nothing."""
    if torch.device(device).type != "cuda":
        return "plain"
    return {None: "A2", "tiled": "F", "streamed": "H"}[blocked_rung(shape)]


# the fresh-dual prox of each route resolve_prox_route names
FRESH_PROX = {"plain": chambolle_prox_plain, "A2": chambolle_prox_cuda,
              "F": chambolle_prox_blocked, "H": chambolle_prox_blocked}


def resolve_fuse_dft(sapg, route: str, fft_mode: str, shape, B: int) -> bool:
    """Whether the step runs kernel D: the JAX rule (estimator.py
    resolve_fuse_dft) with "a TPU backend" read as route 'B' — the fused
    step is not switched off, the transforms are dense DFTs, and fuse_dft
    is True, or None with ≤256² and ≤2 chains.  Launches nothing."""
    if route != "B" or sapg.use_fused_step is False or fft_mode != "dft":
        return False
    fd = sapg.fuse_dft
    if fd is None:
        fd = max(shape) <= 256 and B <= 2
    return bool(fd)


def resolve_in_kernel_rng(sapg, route: str, fft_mode: str, shape, B: int) -> bool:
    """Whether the step draws its noise in the kernel: in_kernel_rng is set,
    the fused step runs on route 'B' (kernel C) or 'I' (the blocked kernel's
    seeds form), and kernel D does not run (JAX resolve_in_kernel_rng).  Off
    at 1024² (route 'G', as the JAX tiled kernel has no seeds) and on the
    'plain' route, so on the CPU the trajectory is the default's."""
    return bool(
        sapg.in_kernel_rng
        and route in ("B", "I")
        and sapg.use_fused_step is not False
        and not resolve_fuse_dft(sapg, route, fft_mode, shape, B)
    )


def _check_ported(cfg) -> None:
    sapg = cfg.sapg
    if sapg.fft_mode not in (None, "fft", "dft"):
        raise ValueError(f"fft_mode must be 'fft' or 'dft', got {sapg.fft_mode!r}")
    if sapg.fft_precision not in (None, "highest"):
        raise NotImplementedError("the port runs its transforms in full precision only")


def make_general_sapg_step(
    model,
    blur,
    cfg,
    sigma_fix: bool,
    route: Optional[str] = None,
    problems: Optional[int] = None,
    chains_group=None,
):
    """Build the per-iteration SAPG step as a function of (carry, ii, consts,
    Z) with consts = dict(yhat, gam, lam, sigma2_lo, sigma2_hi, sigma2_init)
    and Z the step's (B, M, N) standard-normal field, or its (B, 2) int32
    seeds where aux["in_kernel_rng"](B) holds.

    carry = (X, Xhat, prox, theta, sigma2, params) with, under
    track_posterior_moments, a seventh entry extra = dict(pm_mean, pm_m2,
    pm_count); the step returns (carry, trace) with trace a dict of 0-d
    device tensors.  `route` overrides resolve_step_route ('plain', 'B',
    'G' or 'I'); with 'plain'
    the prox takes its plain version too — the chip smoke test compares the
    kernels with the plain versions on the card this way.

    problems=D builds the problem-batched step of the sharded path (the
    counterpart of the JAX package's vmap over a rank's problems): every
    entry of consts has a leading (D,) axis, θ, σ² and each PSF parameter
    are (D,), the fields are (D·C, M, N) problem-major, the kernels get γ,
    λ, λθ and σ² as (D·C,) vectors (one launch for every chain of every
    problem), and the trace entries are (D,).  Each SA statistic is the mean
    over a problem's chains; with `chains_group` (a torch.distributed group
    of S ranks holding the other chains of the same problems) it is then
    all-reduced over the group and divided by S — lax.pmean — in one
    all_reduce a step, on the device."""
    _check_ported(cfg)
    sapg = cfg.sapg
    dtype = blur.dtype
    device = blur.device
    d = blur.dim
    w = blur.weights
    route = resolve_step_route(blur.shape, device) if route is None else route
    if route not in ("plain", "B", "G", "I"):
        raise ValueError(f"unknown step route {route!r}")
    prox_route = "plain" if route == "plain" else resolve_prox_route(blur.shape, device)
    fused = sapg.use_fused_step is not False

    batched = problems is not None
    n_group = 1 if chains_group is None else dist.get_world_size(chains_group)

    def by_problem(t):
        """(D·C, ...) as (D, C, ...) in the batched form."""
        return t.view(problems, -1, *t.shape[1:]) if batched else t

    def flat(t):
        return t.reshape(-1, *t.shape[2:]) if batched else t

    def lead(v):
        """A per-problem quantity against by_problem's chain axis."""
        return v[:, None] if batched else v[None]

    def chains_of(v, C):
        """A per-problem scalar as the kernels' per-chain vector."""
        return v.repeat_interleave(C) if batched else v

    def problem_means(fn, *args):
        """The chain means of the statistics fn(*args) returns, {name: (C,)
        tensor} of ONE problem's quantities, then their average over the
        chains group (one all_reduce for all of them).  Batched, fn runs on
        each problem's slice of the args and the means are stacked to (D,):
        each problem's sums then take the shapes, and so the order, of its
        own run (a sum over a larger batch may split otherwise, and the SA
        loop amplifies a last-bit difference)."""
        if batched:
            outs = [fn(*(a[i] for a in args)) for i in range(problems)]
            out = {k: torch.stack([torch.mean(o[k]) for o in outs]) for k in outs[0]}
        else:
            out = {k: torch.mean(v) for k, v in fn(*args).items()}
        if n_group > 1:
            packed = torch.stack(list(out.values()))
            dist.all_reduce(packed, group=chains_group)
            out = dict(zip(out, (packed / n_group).unbind(0)))
        return out

    def fuse_dft(B):
        return resolve_fuse_dft(sapg, route, blur.fft_mode, blur.shape, B)

    def in_kernel_rng(B):
        return resolve_in_kernel_rng(sapg, route, blur.fft_mode, blur.shape, B)

    # kernel E: JAX's fuse_irdft branch (explicit opt-in, dft mode, fused
    # route B); the step takes it only without in-kernel noise and D
    fuse_irdft = bool(sapg.fuse_irdft) and route == "B" and fused and blur.fft_mode == "dft"

    theta_spec = cfg.theta
    psf_specs = cfg.psf_params
    psf_names = tuple(s.name for s in psf_specs)
    d_scale = sapg.d_scale if sapg.d_scale is not None else 0.01 / theta_spec.init

    # only non-fixed params need OTF gradients; with every PSF param pinned
    # (the published Gaussian config, run_Gaussian_demo.m:42-43) the OTF is
    # a loop constant and is hoisted out of the loop (H0 below)
    free_names = tuple(s.name for s in psf_specs if not s.fix)
    all_fixed = not free_names

    def otfs(params):
        k, dks = model.kernel_and_grads(params)
        stack = torch.stack([k] + [dks[n] for n in free_names])
        # one batched matmul pair for all OTFs (of every problem, batched)
        Hs = blur.otf_batched(stack.reshape(-1, *stack.shape[-2:]))
        Hs = Hs.view(len(stack), *k.shape[:-2], *Hs.shape[-2:])
        return Hs[0], {n: Hs[i + 1] for i, n in enumerate(free_names)}

    def pnorm2(Rhat):
        re, im = Rhat.real, Rhat.imag
        return torch.sum(w[None] * (re * re + im * im), dim=(-2, -1)) / d

    def pdot(Ahat, Bhat):
        return torch.sum(w[None] * (Ahat * torch.conj(Bhat)).real, dim=(-2, -1)) / d

    tv_b = tv_norm

    prox_fn = FRESH_PROX[prox_route]

    def prox_b(X, lam_theta):
        # the fresh form: the SAPG prox starts from zero duals and discards them
        return prox_fn(
            X, lam_theta, sapg.chambolle_iters,
            tau=sapg.chambolle_tau, tol=sapg.chambolle_tol, return_state=False,
        )

    def spatial_segment(X, prox, grad_raw, sigma2, Z, gam, lam, lam_theta, positivity, ikr):
        """The MYULA update with gradF = grad_raw/σ², the prox and the TV;
        with ikr, Z holds the (B, 2) seeds of the in-kernel noise."""
        kw = dict(n_sweeps=sapg.chambolle_iters, tau=sapg.chambolle_tau,
                  tol=sapg.chambolle_tol, positivity=positivity)
        if fused and route == "I":
            if ikr:
                return myula_prox_tv_blocked(X, prox, grad_raw, None, gam, lam, lam_theta,
                                             sigma2, seeds=Z, **kw)
            return myula_prox_tv_blocked(X, prox, grad_raw, Z, gam, lam, lam_theta, sigma2, **kw)
        gradF = grad_raw / per_chain(sigma2, X)
        if fused and route == "G":
            return myula_prox_tv_blocked(X, prox, gradF, Z, gam, lam, lam_theta, **kw)
        if fused and ikr:
            return myula_prox_tv_rng(X, prox, gradF, Z, gam, lam, lam_theta, **kw)
        if fused:
            spatial = myula_prox_tv if route == "B" else myula_prox_tv_plain
            return spatial(X, prox, gradF, Z, gam, lam, lam_theta, **kw)
        Xn = myula_kernel_step(X, prox, gradF, per_chain(gam, X), per_chain(lam, X), Z, positivity)
        proxn, _ = prox_b(Xn, lam_theta)
        return Xn, proxn, tv_b(Xn)

    def advance(X, prox, ghat, sigma2, Z, gam, lam, lam_theta, positivity, irdft_ok):
        """(Xn, proxn, tv, Xhatn) from Ĝ = conj(H)·R̂, in the JAX package's
        branch order: kernel D, kernel E (not in the warm-up), then the
        transforms around the spatial segment.  Batched, ghat is (D, C, M,
        Nh) and the scalars (D,): the kernels get them flat and per chain."""
        B = X.shape[0]
        ghat = flat(ghat)
        gam, lam, lam_theta, sigma2 = (chains_of(v, B // (problems or 1))
                                       for v in (gam, lam, lam_theta, sigma2))
        ikr = in_kernel_rng(B)
        kw = dict(n_sweeps=sapg.chambolle_iters, tau=sapg.chambolle_tau,
                  tol=sapg.chambolle_tol, positivity=positivity)
        if fuse_dft(B):
            return myula_prox_tv_dft(ghat, X, prox, Z, blur.rdft, gam, lam, lam_theta, sigma2,
                                     **kw)
        if irdft_ok and fuse_irdft and not ikr:
            Xn, proxn, tv = myula_prox_tv_irdft(ghat, X, prox, Z, blur.rdft, gam, lam,
                                                lam_theta, sigma2, **kw)
        else:
            Xn, proxn, tv = spatial_segment(X, prox, blur.irfft(ghat), sigma2, Z, gam, lam,
                                            lam_theta, positivity, ikr)
        return Xn, proxn, tv, blur.rfft(Xn)

    def as_t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    fixed_vals = {s.name: s.clip(as_t(s.true_value)) for s in psf_specs if s.fix}
    log_box = {s.name: (torch.log(as_t(s.box[0])), torch.log(as_t(s.box[1])))
               for s in psf_specs}
    log_theta_box = (torch.log(as_t(theta_spec.box[0])), torch.log(as_t(theta_spec.box[1])))
    theta0_c = as_t(theta_spec.init)
    params0_c = {k: as_t(v) for k, v in cfg.init_psf_params().items()}
    H0_c = blur.otf_host(model.kernel(params0_c))
    zero = torch.zeros((), dtype=dtype, device=device)
    burn_in = sapg.burn_in_resolved
    work = {}  # two spare fields of the Welford update, kept across steps

    def welford(extra, Xn, ii):
        """Welford's running posterior mean and M2 over the samples of
        ii > burn_in (the reference's commented-out weldford intent), in
        place, on two spare fields kept across steps.  The JAX step
        adds take·dX with take = 0 up to burn-in, which leaves the sums
        bit-for-bit as they are; ii is a host int here, so that is a skip."""
        if ii <= burn_in:
            return extra
        mean, m2 = extra["pm_mean"], extra["pm_m2"]
        cnt = extra["pm_count"] + 1.0
        key = (tuple(Xn.shape), Xn.dtype, Xn.device)
        if key not in work:
            work.clear()
            work[key] = (torch.empty_like(Xn), torch.empty_like(Xn))
        dX, tmp = work[key]
        torch.sub(Xn, mean, out=dX)
        torch.div(dX, cnt, out=tmp)
        mean.add_(tmp)                      # mean += dX / cnt
        torch.sub(Xn, mean, out=tmp)
        m2.addcmul_(dX, tmp)                # m2 += dX · (Xn − mean_new)
        return dict(pm_mean=mean, pm_m2=m2, pm_count=cnt)

    def step(carry, ii, consts, Z):
        yhat, gam, lam = consts["yhat"], consts["gam"], consts["lam"]
        X, Xhat, prox, theta, sigma2, params = carry[:6]
        H, dHs = (H0_c, {}) if all_fixed else otfs(params)
        Hl = H[None] if all_fixed else lead(H)
        Rhat = Hl * by_problem(Xhat) - lead(yhat)
        # prox lag: the MYULA update uses the prox of the previous iterate,
        # and the new prox is taken at the current (pre-update) θ
        Xn, proxn, tv, Xhatn = advance(
            X, prox, torch.conj(Hl) * Rhat, sigma2, Z, gam, lam, lam * theta,
            sapg.positivity, True,
        )

        def chain_stats(H, Xhn, yhat, tv, theta, sigma2, *dH):
            Rn = H[None] * Xhn - yhat[None]
            res2 = pnorm2(Rn)
            # the θ lag: logπ uses the pre-update θ and σ²
            return dict(
                G_t=d / theta - tv,
                G_s=res2 / (2.0 * sigma2 ** 2) - d / (2.0 * sigma2),
                **{f"G_{n}": pdot(dh[None] * Xhn, Rn) / sigma2 for n, dh in zip(free_names, dH)},
                logPi=-res2 / (2.0 * sigma2) - theta * tv,
                gX=tv,
            )

        Hp = H.expand(problems, *H.shape) if batched and all_fixed else H
        stats = problem_means(chain_stats, Hp, by_problem(Xhatn), yhat, by_problem(tv), theta,
                              sigma2, *(dHs[n] for n in free_names))
        G_t, G_s = stats["G_t"], stats["G_s"]
        G_p = {n: stats[f"G_{n}"] for n in free_names}

        delta_i = d_scale * float(ii) ** (-sapg.d_exp) / d
        if sapg.theta_log_scale:
            # Algorithm-1: eta = log θ, eta += δ·G_θ·θ, clipped in eta-space
            # (SALSA/SAPG_algorithm_1.m:180-182)
            eta_n = torch.clamp(
                torch.log(theta) + theta_spec.step_scale * delta_i * G_t * theta,
                *log_theta_box,
            )
            theta_n = torch.exp(eta_n)
        else:
            theta_n = theta_spec.clip(theta + theta_spec.step_scale * delta_i * G_t)
        params_n = {}
        for s in psf_specs:
            if s.fix:
                params_n[s.name] = fixed_vals[s.name].expand(problems) if batched \
                    else fixed_vals[s.name]
            elif sapg.psf_log_scale:
                # log-space update with the chain-rule factor p, clipped in
                # log space (an extension of the JAX package, opt-in)
                p = params[s.name]
                lp_n = torch.clamp(
                    torch.log(p) + s.sign * s.step_scale * delta_i * G_p[s.name] * p,
                    *log_box[s.name],
                )
                params_n[s.name] = torch.exp(lp_n)
            else:
                cand = params[s.name] + s.sign * s.step_scale * delta_i * G_p[s.name]
                params_n[s.name] = s.clip(cand)
        if sigma_fix:
            sigma_n = consts["sigma2_init"]
        elif sapg.sigma_log_scale:
            # log σ² with the chain-rule factor σ², clipped in log space (an
            # extension of the JAX package, opt-in: it moves far faster from
            # the wide BSNR-midpoint init at large d)
            lsig_n = torch.clamp(
                torch.log(sigma2) + cfg.sigma_step_scale * delta_i * G_s * sigma2,
                torch.log(consts["sigma2_lo"]), torch.log(consts["sigma2_hi"]),
            )
            sigma_n = torch.exp(lsig_n)
        else:
            sigma_n = torch.clamp(
                sigma2 + cfg.sigma_step_scale * delta_i * G_s,
                consts["sigma2_lo"], consts["sigma2_hi"],
            )

        trace = dict(
            theta=theta_n,
            sigma2=sigma_n,
            logPi=stats["logPi"],
            gX=stats["gX"],
            G_t=G_t,
            G_s=G_s,
            **{f"G_{n}": G_p.get(n, zero.expand(problems) if batched else zero)
               for n in psf_names},
            **{n: params_n[n] for n in psf_names},
        )
        carry_n = (Xn, Xhatn, proxn, theta_n, sigma_n, params_n)
        if sapg.track_posterior_moments:
            carry_n += (welford(carry[6], Xn, ii),)
        return carry_n, trace

    # --- warm-up step: MYULA at the fixed initial hyperparameters ---------
    # (SAPG_algorithm_Guassian.m:67-93), positivity always on (the JAX
    # warm step forces it); like the JAX warm step it has no kernel-E
    # branch: under fuse_irdft the warm-up runs kernel B
    def warm_step(carry, consts, Z):
        yhat, gam, lam = consts["yhat"], consts["gam"], consts["lam"]
        sigma0 = consts["sigma2_init"]
        X, Xhat, prox = carry
        Rhat = H0_c[None] * by_problem(Xhat) - lead(yhat)
        Xn, proxn, tv, Xhatn = advance(
            X, prox, torch.conj(H0_c)[None] * Rhat, sigma0, Z, gam, lam, lam * theta0_c,
            True, False,
        )
        return (Xn, Xhatn, proxn), logpi_init(Xhatn, tv, consts)

    def logpi_init(Xhat, tv, consts):
        """logπ at the initial θ and σ², the mean over a problem's chains."""
        def chain_stats(Xh, yhat, tv, sigma0):
            res2 = pnorm2(H0_c[None] * Xh - yhat[None])
            return dict(logPi=-res2 / (2.0 * sigma0) - theta0_c * tv)

        return problem_means(chain_stats, by_problem(Xhat), consts["yhat"], by_problem(tv),
                             consts["sigma2_init"])["logPi"]

    aux = dict(
        psf_names=psf_names,
        prox_b=prox_b,
        tv_b=tv_b,
        pnorm2=pnorm2,
        warm_step=warm_step,
        theta0=theta0_c,
        params0=params0_c,
        H0=H0_c,
        route=route,
        prox_route=prox_route,
        fuse_dft=fuse_dft,
        in_kernel_rng=in_kernel_rng,
        logpi_init=logpi_init,
    )
    return step, aux


def problem_consts(problem: Problem):
    """The per-problem constants consumed by the general SAPG step."""
    return dict(
        yhat=problem.yhat,
        gam=problem.gamma,
        lam=problem.lambda_myula,
        sigma2_lo=problem.sigma2_box[0],
        sigma2_hi=problem.sigma2_box[1],
        sigma2_init=problem.sigma2_init,
    )


def make_sapg_step(problem: Problem, n_chains: int, route: Optional[str] = None):
    """Per-problem SAPG step: (carry, ii, Z) -> (carry, trace); `route` as in
    make_general_sapg_step."""
    cfg = problem.cfg
    sigma_spec = problem.sigma_spec()
    gstep, aux = make_general_sapg_step(
        problem.model, problem.blur, cfg, sigma_fix=sigma_spec.fix, route=route,
    )
    consts = problem_consts(problem)

    def step(carry, ii, Z):
        return gstep(carry, ii, consts, Z)

    aux = dict(aux, lam=problem.lambda_myula, gam=problem.gamma, sigma_spec=sigma_spec,
               consts=consts)
    return step, aux


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _merge_traces(seg_traces):
    if len(seg_traces) == 1:
        return seg_traces[0]
    return {k: np.concatenate([tr[k] for tr in seg_traces]) for k in seg_traces[0]}


def _save_checkpoint(path: str, carry, done_iters: int, seg_traces, logpi_wu, logpi0,
                     generator: Optional[torch.Generator] = None,
                     backend: str = "npz") -> None:
    """Persist (carry, completed-iteration count, trace segments, warm-up
    trace, noise state).

    The JAX package drops Xhat and recomputes it with blur.rfft (its TPU
    could not copy complex buffers to the host); here Xhat is kept as its
    real and imaginary planes, because on route D it comes from the
    kernel's own forward transform, which differs from blur.rfft in the
    last bits.  The noise state is the torch.Generator's get_state() (a
    uint8 array: seed and offset), saved when the run draws its noise from
    `generator`.  The warm-up trace (logpi_wu, logpi0) rides along so a
    resumed run can skip the warm-up phase entirely (15k iterations — 43%
    of the reference budget)."""
    X, Xhat, prox, theta, sigma2, params = carry[:6]
    extra = carry[6] if len(carry) > 6 else {}
    arrays = {f"trace/{k}": v for k, v in _merge_traces(seg_traces).items()}
    arrays.update(
        X=_host(X),
        Xhat_re=_host(Xhat.real),
        Xhat_im=_host(Xhat.imag),
        prox=_host(prox),
        theta=_host(theta),
        sigma2=_host(sigma2),
        done_iters=np.asarray(done_iters),
        logpi_wu=_host(logpi_wu),
        logpi0=_host(logpi0),
    )
    if generator is not None:
        arrays["generator_state"] = generator.get_state().numpy()
    for k, v in params.items():
        arrays[f"param/{k}"] = _host(v)
    for k, v in extra.items():
        arrays[f"extra/{k}"] = _host(v)
    save_checkpoint_arrays(path, arrays, backend=backend)


def _restore_checkpoint(path: str, device, backend: Optional[str] = None, rfft=None,
                        generator: Optional[torch.Generator] = None):
    """Inverse of _save_checkpoint; returns
    (carry, done_iters, [trace dict], logpi_wu, logpi0).

    The tensors land on `device`; a saved generator state is set on
    `generator` (a generator of the problem's device; never reseeded, which
    would change the stream).  `rfft` (the run's blur.rfft) recomputes Xhat
    only for a file without its planes."""
    z = load_checkpoint_arrays(path, backend=backend)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    X = t(z["X"])
    Xhat = torch.complex(t(z["Xhat_re"]), t(z["Xhat_im"])) if "Xhat_re" in z else rfft(X)
    params = {k[len("param/"):]: t(z[k]) for k in z if k.startswith("param/")}
    traces = {k[len("trace/"):]: z[k] for k in z if k.startswith("trace/")}
    extra = {k[len("extra/"):]: float(z[k]) if z[k].ndim == 0 else t(z[k])
             for k in z if k.startswith("extra/")}
    if generator is not None and "generator_state" in z:
        generator.set_state(torch.from_numpy(z["generator_state"]))
    carry = (X, Xhat, t(z["prox"]), t(z["theta"]), t(z["sigma2"]), params)
    if extra:
        carry += (extra,)
    return carry, int(z["done_iters"]), [traces], z["logpi_wu"], z["logpi0"]


def _traces_finite(tr) -> bool:
    """Fail-fast divergence check on a segment's scalar traces."""
    for name in ("logPi", "theta", "sigma2"):
        if name in tr and not np.all(np.isfinite(tr[name])):
            return False
    return True


def run_segmented_scan(
    scan_seg,
    carry,
    samples: int,
    *,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    save_fn=None,
    restore_fn=None,
    fault_hook=None,
    nan_guard: bool = True,
    max_restores: int = 1,
):
    """Drive the segmented main SAPG scan over ii = 2..samples with
    checkpointing and supervision; `scan_seg(carry, iis) -> (carry, host
    trace dict)` runs the iterations of the range iis.

      * segments the scan every `checkpoint_every` iterations and calls
        `save_fn(carry, done_iters, seg_traces)` after each segment;
      * resumes from an existing checkpoint via
        `restore_fn() -> (carry, done_iters, [trace dicts])`;
      * fail-fast NaN guard: if a segment's logPi/theta/sigma2 traces go
        non-finite (e.g. a transient hardware fault corrupted the carry),
        auto-restores from the last good checkpoint and re-runs, up to
        `max_restores` times, then raises SAPGDivergenceError;
      * `fault_hook(seg_idx, carry) -> carry` is the fault-injection point
        (called before each segment).

    Returns (carry, seg_traces) where seg_traces is a list of host-side
    trace dicts (one per completed segment, resumed segments included).
    Each segment reads its traces back to the host once, so checkpointing
    adds one synchronisation a segment and none a step."""
    seg_traces = []
    start_ii = 2
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        carry, done, saved = restore_fn()
        start_ii += done
        seg_traces.extend(saved)

    if checkpoint_every is None:
        if start_ii <= samples:
            carry, tr = scan_seg(carry, range(start_ii, samples + 1))
            if nan_guard and not _traces_finite(tr):
                raise SAPGDivergenceError(
                    f"non-finite SAPG traces in iterations [{start_ii}, {samples}] "
                    "(no checkpoint to restore from)"
                )
            seg_traces.append(tr)
        return carry, seg_traces

    ii = start_ii
    seg_idx = 0
    restores = 0
    while ii <= samples:
        if fault_hook is not None:
            carry = fault_hook(seg_idx, carry)
        end = min(ii + checkpoint_every - 1, samples)
        carry_try, tr = scan_seg(carry, range(ii, end + 1))
        seg_idx += 1
        if nan_guard and not _traces_finite(tr):
            can_restore = (
                restores < max_restores
                and checkpoint_path is not None
                and os.path.exists(checkpoint_path)
            )
            if not can_restore:
                raise SAPGDivergenceError(
                    f"non-finite SAPG traces in iterations [{ii}, {end}]; "
                    f"restores exhausted ({restores}/{max_restores})"
                )
            restores += 1
            carry, done, saved = restore_fn()
            seg_traces = list(saved)
            ii = 2 + done
            continue
        carry = carry_try
        seg_traces.append(tr)
        ii = end + 1
        if checkpoint_path is not None:
            save_fn(carry, ii - 2, seg_traces)
    return carry, seg_traces


def assemble_result(
    problem: Problem,
    psf_names,
    traces: Dict[str, np.ndarray],
    logpi_wu: np.ndarray,
    logpi0: float,
    X_last: np.ndarray,
    extra_out: Dict,
    exec_time: float,
) -> SAPGResult:
    """Host-side post-processing of the scalar traces into the reference
    `results` struct (SAPG_algorithm_Guassian.m:250-306)."""
    cfg = problem.cfg
    sapg = cfg.sapg
    burn_in = sapg.burn_in_resolved
    params0 = cfg.init_psf_params()

    def full_trace(name, init_val):
        return np.concatenate([[init_val], traces[name]])

    thetas = full_trace("theta", cfg.theta.init)
    sigma2s = full_trace("sigma2", float(problem.sigma2_init))
    psf_traces = {n: full_trace(n, float(params0[n])) for n in psf_names}

    mean_thetas, tol_thetas, theta_EB = _running_window_stats(
        thetas, burn_in, log_scale=sapg.theta_log_scale
    )
    mean_sigmas, tol_sigmas, sigma_EB = _running_window_stats(sigma2s, burn_in)
    mean_psf, tol_psf, psf_EB = {}, {}, {}
    for n in psf_names:
        mean_psf[n], tol_psf[n], psf_EB[n] = _running_window_stats(psf_traces[n], burn_in)

    err_psf = _psf_error_trace(problem, psf_traces)

    logPiTrace = np.concatenate([[float(logpi0)], traces["logPi"]])
    n_warm = len(logpi_wu)
    logPiTrace_WU = (
        np.concatenate([[0.0], np.asarray(logpi_wu)]) if n_warm > 0 else np.zeros(0)
    )
    # the reference stores g(X_ii) at index ii-1 and leaves the last slot 0
    gX = np.concatenate([traces["gX"], [0.0]])

    if sapg.track_posterior_moments and extra_out:
        pm_mean = _host(extra_out["pm_mean"])
        cnt = float(extra_out["pm_count"])
        pm_var = _host(extra_out["pm_m2"]) / max(cnt - 1.0, 1.0)
    else:
        pm_mean = pm_var = None

    return SAPGResult(
        theta_EB=theta_EB,
        sigma2_EB=sigma_EB,
        psf_params_EB=psf_EB,
        thetas=thetas,
        sigma2s=sigma2s,
        psf_param_traces=psf_traces,
        logPiTrace=logPiTrace,
        logPiTrace_warmup=logPiTrace_WU,
        gX=gX,
        grad_theta=np.concatenate([[0.0], traces["G_t"]]),
        grad_sigma=np.concatenate([[0.0], traces["G_s"]]),
        grad_psf={n: np.concatenate([[0.0], traces[f"G_{n}"]]) for n in psf_names},
        mean_thetas=mean_thetas,
        mean_sigma2s=mean_sigmas,
        mean_psf=mean_psf,
        tol_thetas=tol_thetas,
        tol_sigma2s=tol_sigmas,
        tol_psf=tol_psf,
        err_psf=err_psf,
        X_last=np.asarray(X_last),
        last_samp=sapg.samples,
        exec_time=exec_time,
        posterior_mean=pm_mean,
        posterior_var=pm_var,
    )


def run_sapg(
    problem: Problem,
    generator: Optional[torch.Generator] = None,
    n_chains: int = 1,
    x0: Optional[torch.Tensor] = None,
    noise: Optional[Callable] = None,
    nan_guard: bool = True,
    mesh=None,
    route: Optional[str] = None,
    seeds: Optional[Callable] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_backend: str = "npz",
    fault_hook=None,
    max_restores: int = 1,
) -> SAPGResult:
    """Run warm-up + SAPG on the problem's device and assemble the full
    diagnostics bundle.

    noise: the noise source (see the module docstring); by default standard
    normals from `generator` (a torch.Generator on the problem's device).
    seeds: the seed source of the in-kernel noise, used instead of `noise`
    where the step draws its noise in the kernel; by default
    generator_seeds(generator).
    mesh: a ('data', 'chains') DeviceMesh (parallel/mesh.make_mesh, data
    axis 1) routes the whole run — warm-up, main scan, checkpointing, EB
    assembly — through parallel/sapg_parallel.run_sapg_sharded with the
    n_chains chains split over the mesh's chains axis.  Every rank of the
    axis draws the whole (n_chains, M, N) field (or the (n_chains, 2) seeds)
    from its copy of `generator` (or asks `noise`/`seeds` for it) and keeps
    its own chains' rows, so the trajectory is run_sapg(n_chains)'s up to
    the order of the cross-chain sums, whatever the layout.
    route: overrides the kernel route (make_general_sapg_step).

    checkpoint_every/checkpoint_path enable mid-run checkpoint + resume:
    the scan is segmented, the carry persisted after each segment, and an
    existing checkpoint at `checkpoint_path` resumes the run mid-way,
    skipping the warm-up (the same trajectory as an uninterrupted run).
    With the default noise or seed source the checkpoint holds the
    generator's state and the resume sets it on `generator`.  An injected
    `noise` or `seeds` callable has no state the run could save: it is
    called once per remaining step, so the caller positions it at the
    checkpoint (the draws of the iterations the checkpoint has done, and of
    the whole warm-up, are not asked for again).
    checkpoint_backend: "npz" (one file) or "orbax" (a directory written
    through torch.distributed.checkpoint, runtime/checkpoint.py).
    nan_guard/max_restores/fault_hook: fail-fast divergence supervision —
    see run_segmented_scan; fault_hook(seg_idx, carry) -> carry gets the
    carry (X, Xhat, prox, θ, σ², params[, extra])."""
    if mesh is not None:
        from semiblind_tv_tpu_torch.parallel.mesh import CHAINS_AXIS, axis_size
        from semiblind_tv_tpu_torch.parallel.sapg_parallel import run_sapg_sharded

        S = axis_size(mesh, CHAINS_AXIS)
        if n_chains % S != 0:
            raise ValueError(f"n_chains={n_chains} not divisible by mesh chains axis {S}")
        return run_sapg_sharded(
            [problem], mesh, [generator], chains_per_shard=n_chains // S, x0=x0,
            noise=None if noise is None else [noise], seeds=None if seeds is None else [seeds],
            route=route, checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
            checkpoint_backend=checkpoint_backend, fault_hook=fault_hook, nan_guard=nan_guard,
            max_restores=max_restores,
        )[0]
    cfg = problem.cfg
    sapg = cfg.sapg
    blur = problem.blur
    dtype = blur.dtype
    device = problem.device
    step, aux = make_sapg_step(problem, n_chains, route=route)
    shape = (n_chains,) + tuple(blur.shape)
    source_generator = None  # the generator whose state is the noise state
    if aux["in_kernel_rng"](n_chains):
        if seeds is None:
            if generator is None:
                raise ValueError("run_sapg needs a generator or a seed source")
            seeds = generator_seeds(generator, device)
            source_generator = generator
        draw = lambda: seeds(n_chains)  # noqa: E731
    else:
        if noise is None:
            if generator is None:
                raise ValueError("run_sapg needs a generator or a noise source")
            noise = generator_noise(generator, dtype, device)
            source_generator = generator
        draw = lambda: noise(shape)  # noqa: E731

    psf_names = aux["psf_names"]
    prox_b, tv_b, pnorm2 = aux["prox_b"], aux["tv_b"], aux["pnorm2"]
    warm_step, consts = aux["warm_step"], aux["consts"]
    lam = aux["lam"]
    theta0, params0, H0 = aux["theta0"], aux["params0"], aux["H0"]
    sigma0 = problem.sigma2_init
    yhat = problem.yhat

    if x0 is None:
        x0 = problem.y  # op.X0 defaults to y (SAPG_algorithm_Guassian.m:10-12)
    X = torch.as_tensor(x0, dtype=dtype, device=device).expand(shape).contiguous()

    n_warm = max(sapg.warmup - 1, 0)

    t0 = time.perf_counter()
    resume = checkpoint_path is not None and os.path.exists(checkpoint_path)
    if resume:
        # the checkpoint carries the warm-up trace — skip the warm-up phase
        # entirely; restore_fn below supplies the carry
        carry = logpi_wu = logpi0 = None
    else:
        prox = prox_b(X, lam * theta0)[0]
        Xhat = blur.rfft(X)
        logpi_wu = torch.empty((n_warm,), dtype=dtype, device=device)
        carry = (X, Xhat, prox)
        for t in range(n_warm):
            carry, logpi_wu[t] = warm_step(carry, consts, draw())
        X, Xhat, prox = carry
        # logPiTraceX(1) = logPi at the warm-start sample with the init params
        res2_0 = pnorm2(H0[None] * Xhat - yhat[None])
        logpi0 = torch.mean(-res2_0 / (2.0 * sigma0) - theta0 * tv_b(X))
        carry = (X, Xhat, prox, theta0, sigma0, dict(params0))
        if sapg.track_posterior_moments:
            carry += (dict(pm_mean=torch.zeros_like(X), pm_m2=torch.zeros_like(X),
                           pm_count=0.0),)

    def scan_seg(carry, iis):
        iis = list(iis)
        names = None
        buf = None
        for t, ii in enumerate(iis):
            carry, tr = step(carry, ii, draw())
            if buf is None:
                names = list(tr)
                buf = torch.empty((len(names), len(iis)), dtype=dtype, device=device)
            buf[:, t] = torch.stack([tr[n] for n in names])
        host = buf.cpu().numpy() if buf is not None else None
        return carry, {n: host[i] for i, n in enumerate(names)} if names else {}

    def restore():
        nonlocal logpi_wu, logpi0
        carry, done, traces, logpi_wu, logpi0 = _restore_checkpoint(
            checkpoint_path, device, backend=checkpoint_backend, rfft=blur.rfft,
            generator=source_generator,
        )
        return carry, done, traces

    def save(carry, done, seg_traces):
        _save_checkpoint(checkpoint_path, carry, done, seg_traces, logpi_wu, logpi0,
                         generator=source_generator, backend=checkpoint_backend)

    carry, seg_traces = run_segmented_scan(
        scan_seg,
        carry,
        sapg.samples,
        checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path,
        save_fn=save,
        restore_fn=restore,
        fault_hook=fault_hook,
        nan_guard=nan_guard,
        max_restores=max_restores,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    exec_time = time.perf_counter() - t0
    traces = _merge_traces(seg_traces) if seg_traces else {}

    return assemble_result(
        problem,
        psf_names,
        traces,
        _host(logpi_wu) if n_warm > 0 else np.zeros(0),
        float(logpi0),
        _host(carry[0]),
        carry[6] if len(carry) > 6 else {},
        exec_time,
    )


def _psf_error_trace(problem: Problem, psf_traces: Dict[str, np.ndarray]) -> np.ndarray:
    """PSF L2-error trace vs the true kernel: the reference's `l2` is
    `norm(x-y)^2` on a 7x7 matrix, the spectral norm squared (utils/l2.m).

    Per-family index quirks preserved:
      * gaussian: psf_gaussian(size, w1s(ii), w2s(ii-1)) — new w1, OLD w2
        (SAPG_algorithm_Guassian.m:203)
      * laplace:  psf_laplace(size, bs(ii))              (_laplace.m:189)
      * moffat:   psf_moffat(size, alphas(ii), betas(ii)) (_moffat.m:205)
    Computed on the host in the problem's dtype, after the run.
    """
    model = problem.model
    dtype = problem.blur.dtype
    args = {n: torch.as_tensor(np.asarray(tr), dtype=dtype) for n, tr in psf_traces.items()}
    if problem.cfg.psf == "gaussian":
        w2 = np.asarray(psf_traces["w2"])
        args["w2"] = torch.as_tensor(np.concatenate([[w2[0]], w2[:-1]]), dtype=dtype)
    kernels = model.kernel(args)
    diffs = kernels - problem.kernel_true.cpu()[None]
    svals = torch.linalg.svdvals(diffs)
    return (svals[:, 0] ** 2).numpy()
