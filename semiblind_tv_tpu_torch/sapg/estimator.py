"""Generic SAPG estimator (port of `semiblind_tv_tpu/sapg/estimator.py`,
one device).

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
fuse_dft, fuse_irdft and in_kernel_rng.

Chains live on the leading dimension; the per-chain SA statistics are
averaged before the hyperparameter update.  θ, σ² and the PSF parameters
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
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from semiblind_tv_tpu_torch.ops.fused_dft_cuda import myula_prox_tv_dft, myula_prox_tv_irdft
from semiblind_tv_tpu_torch.ops.fused_step_cuda import (
    myula_prox_tv,
    myula_prox_tv_blocked,
    myula_prox_tv_plain,
    myula_prox_tv_rng,
)
from semiblind_tv_tpu_torch.ops.tv import tv_norm
from semiblind_tv_tpu_torch.ops.tv_blocked_cuda import blocked_rung, chambolle_prox_blocked
from semiblind_tv_tpu_torch.ops.tv_cuda import chambolle_prox_cuda, chambolle_prox_plain
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


_NOT_PORTED = ("track_posterior_moments",)


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
    for name in _NOT_PORTED:
        if getattr(sapg, name):
            raise NotImplementedError(f"SAPGConfig.{name} is not ported yet")
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
):
    """Build the per-iteration SAPG step as a function of (carry, ii, consts,
    Z) with consts = dict(yhat, gam, lam, sigma2_lo, sigma2_hi, sigma2_init)
    and Z the step's (B, M, N) standard-normal field, or its (B, 2) int32
    seeds where aux["in_kernel_rng"](B) holds.

    carry = (X, Xhat, prox, theta, sigma2, params); the step returns
    (carry, trace) with trace a dict of 0-d device tensors.  `route`
    overrides resolve_step_route ('plain', 'B', 'G' or 'I'); with 'plain'
    the prox takes its plain version too — the chip smoke test compares the
    kernels with the plain versions on the card this way."""
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
        Hs = blur.otf_batched(stack)  # one batched matmul pair for all OTFs
        return Hs[0], {n: Hs[i + 1] for i, n in enumerate(free_names)}

    def pnorm2(Rhat):
        re, im = Rhat.real, Rhat.imag
        return torch.sum(w[None] * (re * re + im * im), dim=(-2, -1)) / d

    def pdot(Ahat, Bhat):
        return torch.sum(w[None] * (Ahat * torch.conj(Bhat)).real, dim=(-2, -1)) / d

    tv_b = tv_norm

    prox_fn = {"plain": chambolle_prox_plain, "A2": chambolle_prox_cuda,
               "F": chambolle_prox_blocked, "H": chambolle_prox_blocked}[prox_route]

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
        gradF = grad_raw / sigma2
        if fused and route == "G":
            return myula_prox_tv_blocked(X, prox, gradF, Z, gam, lam, lam_theta, **kw)
        if fused and ikr:
            return myula_prox_tv_rng(X, prox, gradF, Z, gam, lam, lam_theta, **kw)
        if fused:
            spatial = myula_prox_tv if route == "B" else myula_prox_tv_plain
            return spatial(X, prox, gradF, Z, gam, lam, lam_theta, **kw)
        Xn = myula_kernel_step(X, prox, gradF, gam, lam, Z, positivity)
        proxn, _ = prox_b(Xn, lam_theta)
        return Xn, proxn, tv_b(Xn)

    def advance(X, prox, ghat, sigma2, Z, gam, lam, lam_theta, positivity, irdft_ok):
        """(Xn, proxn, tv, Xhatn) from Ĝ = conj(H)·R̂, in the JAX package's
        branch order: kernel D, kernel E (not in the warm-up), then the
        transforms around the spatial segment."""
        B = X.shape[0]
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

    def step(carry, ii, consts, Z):
        yhat, gam, lam = consts["yhat"], consts["gam"], consts["lam"]
        X, Xhat, prox, theta, sigma2, params = carry
        H, dHs = (H0_c, {}) if all_fixed else otfs(params)
        Rhat = H[None] * Xhat - yhat[None]
        # prox lag: the MYULA update uses the prox of the previous iterate,
        # and the new prox is taken at the current (pre-update) θ
        Xn, proxn, tv, Xhatn = advance(
            X, prox, torch.conj(H)[None] * Rhat, sigma2, Z, gam, lam, lam * theta,
            sapg.positivity, True,
        )
        Rn = H[None] * Xhatn - yhat[None]
        res2 = pnorm2(Rn)

        G_t = torch.mean(d / theta - tv)
        G_s = torch.mean(res2 / (2.0 * sigma2 ** 2) - d / (2.0 * sigma2))
        G_p = {n: torch.mean(pdot(dHs[n][None] * Xhatn, Rn) / sigma2) for n in free_names}

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
                params_n[s.name] = fixed_vals[s.name]
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

        # θ lag: logπ uses the pre-update θ and σ²
        logpi = torch.mean(-res2 / (2.0 * sigma2) - theta * tv)
        trace = dict(
            theta=theta_n,
            sigma2=sigma_n,
            logPi=logpi,
            gX=torch.mean(tv),
            G_t=G_t,
            G_s=G_s,
            **{f"G_{n}": G_p.get(n, zero) for n in psf_names},
            **{n: params_n[n] for n in psf_names},
        )
        return (Xn, Xhatn, proxn, theta_n, sigma_n, params_n), trace

    # --- warm-up step: MYULA at the fixed initial hyperparameters ---------
    # (SAPG_algorithm_Guassian.m:67-93), positivity always on (the JAX
    # warm step forces it); like the JAX warm step it has no kernel-E
    # branch: under fuse_irdft the warm-up runs kernel B
    def warm_step(carry, consts, Z):
        yhat, gam, lam = consts["yhat"], consts["gam"], consts["lam"]
        sigma0 = consts["sigma2_init"]
        X, Xhat, prox = carry
        Rhat = H0_c[None] * Xhat - yhat[None]
        Xn, proxn, tv, Xhatn = advance(
            X, prox, torch.conj(H0_c)[None] * Rhat, sigma0, Z, gam, lam, lam * theta0_c,
            True, False,
        )
        res2 = pnorm2(H0_c[None] * Xhatn - yhat[None])
        logpi = torch.mean(-res2 / (2.0 * sigma0) - theta0_c * tv)
        return (Xn, Xhatn, proxn), logpi

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


def _traces_finite(tr) -> bool:
    for name in ("logPi", "theta", "sigma2"):
        if name in tr and not np.all(np.isfinite(tr[name])):
            return False
    return True


def run_segmented_scan(scan_seg, carry, samples: int, *, nan_guard: bool = True):
    """Drive the main SAPG scan over ii = 2..samples with the fail-fast NaN
    guard: `scan_seg(carry, iis) -> (carry, host trace dict)`.  Raises
    SAPGDivergenceError when the logPi/theta/sigma2 traces go non-finite.
    (Checkpointing and restore are not ported yet.)  Returns (carry,
    [trace dict])."""
    seg_traces = []
    if samples >= 2:
        carry, tr = scan_seg(carry, range(2, samples + 1))
        if nan_guard and not _traces_finite(tr):
            raise SAPGDivergenceError(
                f"non-finite SAPG traces in iterations [2, {samples}] "
                "(no checkpoint to restore from)"
            )
        seg_traces.append(tr)
    return carry, seg_traces


def assemble_result(
    problem: Problem,
    psf_names,
    traces: Dict[str, np.ndarray],
    logpi_wu: np.ndarray,
    logpi0: float,
    X_last: np.ndarray,
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
) -> SAPGResult:
    """Run warm-up + SAPG on the problem's device and assemble the full
    diagnostics bundle.

    noise: the noise source (see the module docstring); by default standard
    normals from `generator` (a torch.Generator on the problem's device).
    seeds: the seed source of the in-kernel noise, used instead of `noise`
    where the step draws its noise in the kernel; by default
    generator_seeds(generator).
    mesh: the JAX package's sharded path; not ported yet (raises).
    route: overrides the kernel route (make_general_sapg_step)."""
    if mesh is not None:
        raise NotImplementedError("the sharded (mesh) SAPG path is not ported yet")
    cfg = problem.cfg
    sapg = cfg.sapg
    blur = problem.blur
    dtype = blur.dtype
    device = problem.device
    step, aux = make_sapg_step(problem, n_chains, route=route)
    shape = (n_chains,) + tuple(blur.shape)
    if aux["in_kernel_rng"](n_chains):
        if seeds is None:
            if generator is None:
                raise ValueError("run_sapg needs a generator or a seed source")
            seeds = generator_seeds(generator, device)
        draw = lambda: seeds(n_chains)  # noqa: E731
    else:
        if noise is None:
            if generator is None:
                raise ValueError("run_sapg needs a generator or a noise source")
            noise = generator_noise(generator, dtype, device)
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

    carry, seg_traces = run_segmented_scan(scan_seg, carry, sapg.samples, nan_guard=nan_guard)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    exec_time = time.perf_counter() - t0
    traces = seg_traces[0] if seg_traces else {}

    return assemble_result(
        problem,
        psf_names,
        traces,
        logpi_wu.cpu().numpy(),
        float(logpi0),
        carry[0].cpu().numpy(),
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
