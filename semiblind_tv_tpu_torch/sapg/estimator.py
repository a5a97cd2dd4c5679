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

One run loop runs every SAPG run (run_sapg_layout, SAPGRun): a rank's share
of D problems × C chains, which parallel/mesh.rank_layout reads from a
('data', 'chains') mesh (run_sapg(mesh=), parallel/sapg_parallel.py); a
run on one device is its case of one problem, every chain and no process
group.  The step is problem-batched (make_general_sapg_step): the chains
of the problems live on the leading dimension, problem-major, and each
problem's per-chain SA statistics are averaged before its hyperparameter
update.  θ, σ² and the PSF parameters are (D,) device tensors, the SA
updates use torch.clamp, and the scalar traces go into preallocated device
tensors that are copied to the host once a segment: nothing inside the
loop waits for the device.

Spans (runtime/profiling.py; recorded only while the recorder is on):
`sapg.run` around a run, with `sapg.prologue` (set-up, the initial prox and
transform), `sapg.warmup` (one `sapg.warm_step` a warm-up step),
`sapg.segment` (one a scan segment, its host read-back included) and
`sapg.assemble` (the synchronize, the sweep counts folded, the host
copies and assemble_result); each main iteration is a `sapg.step` with the
children `sapg.noise`, `psf.otf` (a free PSF parameter only),
`sapg.residual` (Ĝ = conj(H)·(H·X̂ − ŷ) and λθ), `fourier.irfft`,
`kernel.step`, `fourier.rfft`, `sapg.stats`, `sapg.update` and
`sapg.trace`, and a warm step has those that apply.  A replayed iteration
(below) enters only `sapg.step` (or `sapg.warm_step`) and `sapg.noise`:
its other spans were entered when the graph was captured, under
`sapg.capture`.

CUDA graphs: where resolve_graph_replay holds (a CUDA device, route 'B'
with kernel B, fft_mode 'fft', a noise field, no posterior moments), a run
replays each warm-up iteration and each SAPG iteration as CUDA graphs
captured from the same step (_GraphIterations): one graph on one device,
and on a mesh the pieces between the step's all_reduce calls, which run
eagerly between them.  They are kept in the first problem's step_graphs
and reused by the next runs of the same problems and layout; the host then
only draws the noise, copies it into the graph's input and replays.  The
step holds no host scalar for this: the SA updates read their step
coefficients from a device table (sa_step_coefficients), and the traces
are stored at a device index the graph advances.  Every other case runs
the same step eagerly.  The counters `graph.captures`, `graph.replays` and
`graph.eager_steps` (iterations run without a replay) say how often it
engages.

The noise source is injectable: `noise(shape) -> (B, M, N) tensor` is
called once per warm-up and main step, in that order; the default draws
standard normals from the run's torch.Generator.  With in-kernel
noise the seed source `seeds(B) -> (B, 2) int32 tensor` is called instead
(default: `generator_seeds`, the counterpart of the JAX chain_seeds).  Its
noise realisation differs from the default's, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

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
from semiblind_tv_tpu_torch.parallel.mesh import CHAINS_AXIS, RankLayout, axis_size, rank_layout
from semiblind_tv_tpu_torch.runtime.checkpoint import load_checkpoint_arrays, save_checkpoint_arrays
from semiblind_tv_tpu_torch.runtime.problem import Problem
from semiblind_tv_tpu_torch.runtime import profiling
from semiblind_tv_tpu_torch.runtime.profiling import counters, fold_sweeps, span
from semiblind_tv_tpu_torch.samplers.myula import myula_kernel_step

__all__ = [
    "SAPGResult",
    "SAPGDivergenceError",
    "run_sapg",
    "run_sapg_layout",
    "SAPGRun",
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
    "resolve_graph_replay",
    "sa_step_coefficients",
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


def resolve_graph_replay(sapg, route: str, fft_mode: str, device, shape, B: int) -> bool:
    """Whether a run replays its warm-up and SAPG iterations as CUDA graphs:
    on a CUDA device, on route 'B' with the fused step (kernel B), fft_mode
    'fft', a noise field (not the in-kernel noise's seeds) and no posterior
    moments (Welford's update branches on the host's ii).  Everywhere else
    the same step runs eagerly.  B is a problem's chains on the rank.
    Launches nothing."""
    return bool(
        torch.device(device).type == "cuda"
        and route == "B"
        and sapg.use_fused_step is not False
        and fft_mode == "fft"
        and not resolve_in_kernel_rng(sapg, route, fft_mode, shape, B)
        and not sapg.track_posterior_moments
    )


def sa_step_coefficients(cfg, dim: int) -> np.ndarray:
    """The SA updates' step coefficients, float64, one column an iteration
    ii = 0..samples (columns 0 and 1 unused, zero): row 0 θ's
    step_scale·δ(ii), row 1 σ²'s sigma_step_scale·δ(ii), then
    sign·step_scale·δ(ii) of each free PSF parameter in order, with
    δ(ii) = d_scale·ii^(−d_exp)/dim (SAPG_algorithm_Guassian.m:55).  Each
    is formed as Python floats in the order of the update's scalar
    expression, so its cast to the run's dtype times a statistic rounds as
    that expression times the statistic does."""
    sapg = cfg.sapg
    d_scale = sapg.d_scale if sapg.d_scale is not None else 0.01 / cfg.theta.init
    scales = [cfg.theta.step_scale, cfg.sigma_step_scale] + [
        s.sign * s.step_scale for s in cfg.psf_params if not s.fix]
    cols = [[0.0] * len(scales)] * 2
    for ii in range(2, sapg.samples + 1):
        delta_i = d_scale * float(ii) ** (-sapg.d_exp) / dim
        cols.append([c * delta_i for c in scales])
    return np.array(cols, dtype=np.float64).T.copy()


def _coefficients(table: torch.Tensor, ii):
    """Column ii of the coefficient table: a view for a host int, a gather
    for a device index (a (1,) int64 tensor, which a CUDA graph advances)."""
    if isinstance(ii, int):
        return table[:, ii]
    return table.index_select(1, ii)[:, 0]


def _store(buf: torch.Tensor, i, value: torch.Tensor) -> None:
    """buf[..., i] = value, for a host int i or a device index."""
    if isinstance(i, int):
        buf[..., i] = value
    else:
        buf.index_copy_(buf.ndim - 1, i, value.unsqueeze(-1))


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
    problems: int = 1,
    chains_group=None,
):
    """Build the per-iteration SAPG step of a batch of `problems` problems
    (the counterpart of the JAX package's vmap over a rank's problems) as a
    function of (carry, ii, consts, Z) with consts = dict(yhat, gam, lam,
    sigma2_lo, sigma2_hi, sigma2_init) of the problems (problem_consts) and
    Z the step's (D·C, M, N) standard-normal field, or its (D·C, 2) int32
    seeds where aux["in_kernel_rng"](C) holds.

    carry = (X, Xhat, prox, theta, sigma2, params) with, under
    track_posterior_moments, a seventh entry extra = dict(pm_mean, pm_m2,
    pm_count); aux["main_carry"] forms the first.  Every entry of consts,
    θ, σ², each PSF parameter and each entry of the step's trace has a
    leading (D,) axis, and the fields are (D·C, M, N) problem-major.  The
    kernels get γ, λ, λθ and σ² per chain, (D·C,) vectors, in one launch for
    every chain of every problem; for one problem they get them as they
    are, (1,), which the kernels read at stride 0.  Each SA statistic is the
    mean over a problem's chains, summed on the shapes of the problem's own
    run.  ii is the iteration, a host int or, without the
    posterior moments, a (1,) int64 device tensor: the SA updates read
    their step coefficients (sa_step_coefficients) from a device table at
    column ii, so the step holds no host scalar and a CUDA graph can
    capture it.  `route` overrides resolve_step_route ('plain', 'B',
    'G' or 'I'); with 'plain'
    the prox takes its plain version too — the chip smoke test compares the
    kernels with the plain versions on the card this way.

    With `chains_group` (a torch.distributed group of S ranks holding the
    other chains of the same problems) each SA statistic is then
    all-reduced over the group and divided by S — lax.pmean — in one
    all_reduce a step, on the device: aux["all_reduce"](packed), or, while
    aux["cuts"] holds a function, that function, which a piecewise CUDA
    graph capture ends its graph at (_GraphIterations)."""
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

    n_group = 1 if chains_group is None else dist.get_world_size(chains_group)

    def by_problem(t):
        """(D·C, ...) as (D, C, ...)."""
        return t.view(problems, -1, *t.shape[1:])

    def flat(t):
        return t.reshape(-1, *t.shape[2:])

    def lead(v):
        """A per-problem quantity against by_problem's chain axis."""
        return v[:, None]

    def chains_of(v, C):
        """A per-problem scalar as the kernels' per-chain vector; one
        problem's (1,) as it is (the kernels broadcast it)."""
        return v if problems == 1 else v.repeat_interleave(C)

    cuts = []

    def all_reduce(packed):
        """packed summed over the chains group, in place."""
        counters.add("collective.all_reduce.calls")
        counters.add("collective.all_reduce.bytes", packed.numel() * packed.element_size())
        with span("sapg.allreduce"):
            dist.all_reduce(packed, group=chains_group)

    def problem_means(fn, *args):
        """The chain means of the statistics fn(*args) returns, {name: (C,)
        tensor} of ONE problem's quantities, as (D,), then their average over
        the chains group (one all_reduce for all of them).  fn runs on each
        problem's slice of the args, so each problem's sums take the shapes,
        and so the order, of its own run (a sum over a larger batch may split
        otherwise, and the SA loop amplifies a last-bit difference); one
        problem's means take the problem axis as a view, not a copy."""
        means = [{k: torch.mean(v) for k, v in fn(*(a[i] for a in args)).items()}
                 for i in range(problems)]
        out = {k: means[0][k][None] if problems == 1 else torch.stack([m[k] for m in means])
               for k in means[0]}
        if n_group > 1:
            packed = torch.stack(list(out.values()))
            (cuts[-1] if cuts else all_reduce)(packed)
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

    # only non-fixed params need OTF gradients; with every PSF param pinned
    # (the published Gaussian config, run_Gaussian_demo.m:42-43) the OTF is
    # a loop constant and is hoisted out of the loop (H0 below)
    free_names = tuple(s.name for s in psf_specs if not s.fix)
    all_fixed = not free_names
    # the SA updates' step coefficients over ii, rows as sa_step_coefficients
    coef_table = torch.from_numpy(sa_step_coefficients(cfg, d)).to(dtype).to(device)
    coef_row = {n: 2 + j for j, n in enumerate(free_names)}

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
        transforms around the spatial segment.  ghat is (D, C, M, Nh) and
        the scalars (D,): the kernels get them flat and per chain.  The
        chain-count rules of D and the in-kernel noise see one problem's
        chains, as the JAX package's vmap over the problems does."""
        C = X.shape[0] // problems
        ghat = flat(ghat)
        gam, lam, lam_theta, sigma2 = (chains_of(v, C) for v in (gam, lam, lam_theta, sigma2))
        ikr = in_kernel_rng(C)
        kw = dict(n_sweeps=sapg.chambolle_iters, tau=sapg.chambolle_tau,
                  tol=sapg.chambolle_tol, positivity=positivity)
        if fuse_dft(C):
            with span("kernel.step"):
                return myula_prox_tv_dft(ghat, X, prox, Z, blur.rdft, gam, lam, lam_theta,
                                         sigma2, **kw)
        if irdft_ok and fuse_irdft and not ikr:
            with span("kernel.step"):
                Xn, proxn, tv = myula_prox_tv_irdft(ghat, X, prox, Z, blur.rdft, gam, lam,
                                                    lam_theta, sigma2, **kw)
        else:
            with span("fourier.irfft"):
                grad_raw = blur.irfft(ghat)
            with span("kernel.step"):
                Xn, proxn, tv = spatial_segment(X, prox, grad_raw, sigma2, Z, gam, lam,
                                                lam_theta, positivity, ikr)
        with span("fourier.rfft"):
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
        if all_fixed:
            H, dHs = H0_c, {}
        else:
            with span("psf.otf"):
                H, dHs = otfs(params)
        with span("sapg.residual"):
            Hl = H[None] if all_fixed else lead(H)
            Rhat = Hl * by_problem(Xhat) - lead(yhat)
            ghat = torch.conj(Hl) * Rhat
            # prox lag: the MYULA update uses the prox of the previous
            # iterate, and the new prox is taken at the current (pre-update) θ
            lam_theta = lam * theta
        Xn, proxn, tv, Xhatn = advance(X, prox, ghat, sigma2, Z, gam, lam, lam_theta,
                                       sapg.positivity, True)

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

        Hp = H.expand(problems, *H.shape) if all_fixed else H
        with span("sapg.stats"):
            stats = problem_means(chain_stats, Hp, by_problem(Xhatn), yhat, by_problem(tv),
                                  theta, sigma2, *(dHs[n] for n in free_names))
        with span("sapg.update"):
            return update(carry, ii, consts, stats, Xn, Xhatn, proxn)

    def update(carry, ii, consts, stats, Xn, Xhatn, proxn):
        """The SA updates of θ, σ² and the free PSF parameters from the
        step's statistics, Welford's, and the step's (carry, trace)."""
        theta, sigma2, params = carry[3:6]
        G_t, G_s = stats["G_t"], stats["G_s"]
        G_p = {n: stats[f"G_{n}"] for n in free_names}

        coef = _coefficients(coef_table, ii)
        if sapg.theta_log_scale:
            # Algorithm-1: eta = log θ, eta += δ·G_θ·θ, clipped in eta-space
            # (SALSA/SAPG_algorithm_1.m:180-182)
            eta_n = torch.clamp(torch.log(theta) + coef[0] * G_t * theta, *log_theta_box)
            theta_n = torch.exp(eta_n)
        else:
            theta_n = theta_spec.clip(theta + coef[0] * G_t)
        params_n = {}
        for s in psf_specs:
            if s.fix:
                params_n[s.name] = fixed_vals[s.name].expand(problems)
            elif sapg.psf_log_scale:
                # log-space update with the chain-rule factor p, clipped in
                # log space (an extension of the JAX package, opt-in)
                p = params[s.name]
                lp_n = torch.clamp(torch.log(p) + coef[coef_row[s.name]] * G_p[s.name] * p,
                                   *log_box[s.name])
                params_n[s.name] = torch.exp(lp_n)
            else:
                params_n[s.name] = s.clip(params[s.name] + coef[coef_row[s.name]] * G_p[s.name])
        if sigma_fix:
            sigma_n = consts["sigma2_init"]
        elif sapg.sigma_log_scale:
            # log σ² with the chain-rule factor σ², clipped in log space (an
            # extension of the JAX package, opt-in: it moves far faster from
            # the wide BSNR-midpoint init at large d)
            lsig_n = torch.clamp(
                torch.log(sigma2) + coef[1] * G_s * sigma2,
                torch.log(consts["sigma2_lo"]), torch.log(consts["sigma2_hi"]),
            )
            sigma_n = torch.exp(lsig_n)
        else:
            sigma_n = torch.clamp(sigma2 + coef[1] * G_s, consts["sigma2_lo"], consts["sigma2_hi"])

        trace = dict(
            theta=theta_n,
            sigma2=sigma_n,
            logPi=stats["logPi"],
            gX=stats["gX"],
            G_t=G_t,
            G_s=G_s,
            **{f"G_{n}": G_p.get(n, zero.expand(problems)) for n in psf_names},
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
        with span("sapg.residual"):
            Rhat = H0_c[None] * by_problem(Xhat) - lead(yhat)
            ghat = torch.conj(H0_c)[None] * Rhat
            lam_theta = lam * theta0_c
        Xn, proxn, tv, Xhatn = advance(X, prox, ghat, sigma0, Z, gam, lam, lam_theta, True,
                                       False)
        with span("sapg.stats"):
            return (Xn, Xhatn, proxn), logpi_init(Xhatn, tv, consts)

    def logpi_init(Xhat, tv, consts):
        """logπ at the initial θ and σ², the mean over a problem's chains."""
        def chain_stats(Xh, yhat, tv, sigma0):
            res2 = pnorm2(H0_c[None] * Xh - yhat[None])
            return dict(logPi=-res2 / (2.0 * sigma0) - theta0_c * tv)

        return problem_means(chain_stats, by_problem(Xhat), consts["yhat"], by_problem(tv),
                             consts["sigma2_init"])["logPi"]

    def main_carry(warm_carry, consts):
        """The main scan's first carry from the warm-up's last (X, X̂, prox):
        θ, σ² and the PSF parameters at their initial values, (D,), and
        under track_posterior_moments zero moments."""
        def full(v):
            return torch.full((problems,), v, dtype=dtype, device=device)

        X = warm_carry[0]
        carry = tuple(warm_carry) + (full(theta_spec.init), consts["sigma2_init"].clone(),
                                     {k: full(v) for k, v in cfg.init_psf_params().items()})
        if sapg.track_posterior_moments:
            carry += (dict(pm_mean=torch.zeros_like(X), pm_m2=torch.zeros_like(X),
                           pm_count=0.0),)
        return carry

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
        main_carry=main_carry,
        chains_of=chains_of,
        all_reduce=all_reduce,
        cuts=cuts,
    )
    return step, aux


def problem_consts(problems: Sequence[Problem]) -> dict:
    """The constants of the general SAPG step for `problems`, each with a
    leading problem axis: one problem's as views of its tensors, several
    problems' stacked."""
    consts = [dict(yhat=p.yhat, gam=p.gamma, lam=p.lambda_myula, sigma2_lo=p.sigma2_box[0],
                   sigma2_hi=p.sigma2_box[1], sigma2_init=p.sigma2_init) for p in problems]
    if len(consts) == 1:
        return {k: v[None] for k, v in consts[0].items()}
    return {k: torch.stack([c[k] for c in consts]) for k in consts[0]}


def make_sapg_step(problem: Problem, n_chains: int, route: Optional[str] = None):
    """One problem's SAPG step: (carry, ii, Z) -> (carry, trace), the
    general step of a batch of one problem, so θ, σ² and the PSF
    parameters of the carry and the trace's entries are (1,);
    aux["main_carry"]((X, X̂, prox), aux["consts"]) is a main scan's first
    carry.  `route` as in make_general_sapg_step."""
    gstep, aux = make_general_sapg_step(
        problem.model, problem.blur, problem.cfg, sigma_fix=problem.sigma_spec().fix,
        route=route,
    )
    consts = problem_consts([problem])

    def step(carry, ii, Z):
        return gstep(carry, ii, consts, Z)

    return step, dict(aux, lam=problem.lambda_myula, consts=consts)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _merge_traces(seg_traces):
    if len(seg_traces) == 1:
        return seg_traces[0]
    return {k: np.concatenate([tr[k] for tr in seg_traces]) for k in seg_traces[0]}


def _state_keys(layout: RankLayout, n: int):
    """The checkpoint's keys of n generator states."""
    if layout.rank is None:
        return ["generator_state"]
    return [f"generator_state/{i}" for i in range(n)]


def _save_checkpoint(path: str, layout: RankLayout, carry, done_iters: int, seg_traces,
                     logpi_wu, logpi0, generators, backend: str) -> None:
    """Persist a rank's carry, completed-iteration count, trace segments,
    warm-up trace and noise state.

    The JAX package drops Xhat and recomputes it with blur.rfft (its TPU
    could not copy complex buffers to the host); here Xhat is kept as its
    real and imaginary planes, because on route D it comes from the
    kernel's own forward transform, which differs from blur.rfft in the
    last bits.  The noise state is each torch.Generator's get_state() (a
    uint8 array: seed and offset) that the run draws from.  The warm-up
    trace (logpi_wu, logpi0) rides along so a resumed run can skip the
    warm-up phase entirely (15k iterations — 43% of the reference budget).

    The layout gives the file's form: a run on one device (no rank) writes
    its one problem's arrays without the problem axis (0-d θ and σ², 1-D
    traces) and its generator's state as `generator_state`; a rank of a
    mesh keeps the axis, keys its arrays `rank<r>/` and its problems'
    states `generator_state/<i>`."""
    X, Xhat, prox, theta, sigma2, params = carry[:6]
    extra = carry[6] if len(carry) > 6 else {}
    one = layout.rank is None
    own = (lambda v: _host(v)[..., 0]) if one else _host   # noqa: E731
    arrays = {f"trace/{k}": own(v) for k, v in _merge_traces(seg_traces).items()}
    arrays.update(
        X=_host(X),
        Xhat_re=_host(Xhat.real),
        Xhat_im=_host(Xhat.imag),
        prox=_host(prox),
        theta=own(theta),
        sigma2=own(sigma2),
        done_iters=np.asarray(done_iters),
        logpi_wu=own(logpi_wu),
        logpi0=own(logpi0),
    )
    arrays.update(zip(_state_keys(layout, len(generators)),
                      (g.get_state().numpy() for g in generators)))
    for k, v in params.items():
        arrays[f"param/{k}"] = own(v)
    for k, v in extra.items():
        arrays[f"extra/{k}"] = _host(v)
    pre = "" if one else f"rank{layout.rank}/"
    save_checkpoint_arrays(path, {pre + k: v for k, v in arrays.items()}, backend=backend)


def _restore_checkpoint(path: str, layout: RankLayout, generators, backend: str, rfft):
    """Inverse of _save_checkpoint for this rank: (carry, done_iters,
    [trace dict], logpi_wu, logpi0), with the problem axis.

    The tensors land on the layout's device; a saved generator state is
    set on its generator (never reseeded, which would change the stream).
    `rfft` (the run's blur.rfft) recomputes Xhat only for a file without
    its planes."""
    one = layout.rank is None
    pre = "" if one else f"rank{layout.rank}/"
    z = {k[len(pre):]: v for k, v in
         load_checkpoint_arrays(path, backend=backend, prefix=pre).items()}
    own = (lambda a: np.asarray(a)[..., None]) if one else np.asarray   # noqa: E731

    def t(a):
        return torch.from_numpy(np.array(a)).to(layout.device)

    X = t(z["X"])
    Xhat = torch.complex(t(z["Xhat_re"]), t(z["Xhat_im"])) if "Xhat_re" in z else rfft(X)
    params = {k[len("param/"):]: t(own(z[k])) for k in z if k.startswith("param/")}
    traces = {k[len("trace/"):]: own(z[k]) for k in z if k.startswith("trace/")}
    extra = {k[len("extra/"):]: float(z[k]) if z[k].ndim == 0 else t(z[k])
             for k in z if k.startswith("extra/")}
    for key, g in zip(_state_keys(layout, len(generators)), generators):
        if key in z:
            g.set_state(torch.from_numpy(z[key]))
    carry = (X, Xhat, t(z["prox"]), t(own(z["theta"])), t(own(z["sigma2"])), params)
    if extra:
        carry += (extra,)
    return carry, int(z["done_iters"]), [traces], own(z["logpi_wu"]), own(z["logpi0"])


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
    _graphs: bool = True,
) -> SAPGResult:
    """Run warm-up + SAPG on the problem's device and assemble the full
    diagnostics bundle: run_sapg_layout for one problem.

    noise: the noise source (see the module docstring); by default standard
    normals from `generator` (a torch.Generator on the problem's device).
    seeds: the seed source of the in-kernel noise, used instead of `noise`
    where the step draws its noise in the kernel; by default
    generator_seeds(generator).
    mesh: a ('data', 'chains') DeviceMesh (parallel/mesh.make_mesh, data
    axis 1) splits the n_chains chains over the mesh's chains axis
    (parallel/mesh.rank_layout) for the whole run — warm-up, main scan,
    checkpointing, EB assembly.  Every rank of the axis draws the whole
    (n_chains, M, N) field (or the (n_chains, 2) seeds) from its copy of
    `generator` (or asks `noise`/`seeds` for it) and keeps its own chains'
    rows, so the trajectory is run_sapg(n_chains)'s up to the order of the
    cross-chain sums, whatever the layout.
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
    carry (X, Xhat, prox, θ, σ², params[, extra]) with the problem axis:
    θ, σ² and each PSF parameter are (1,); where the iterations replay as
    CUDA graphs (module docstring) that carry is the graphs' buffers, valid
    until the next iteration.  _graphs=False runs the step eagerly where
    the graphs would engage (for tests)."""
    if mesh is None:
        layout = RankLayout(problems=range(1), rows=slice(0, n_chains), device=problem.device)
    else:
        S = axis_size(mesh, CHAINS_AXIS)
        if n_chains % S != 0:
            raise ValueError(f"n_chains={n_chains} not divisible by mesh chains axis {S}")
        layout = rank_layout(mesh, 1, n_chains // S)
    return run_sapg_layout(
        [problem], layout, None if generator is None else [generator], x0=x0,
        noise=None if noise is None else [noise], seeds=None if seeds is None else [seeds],
        route=route, checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        checkpoint_backend=checkpoint_backend, fault_hook=fault_hook, nan_guard=nan_guard,
        max_restores=max_restores, _graphs=_graphs,
    )[0]


class _Iterations:
    """A rank's warm-up and SAPG iterations, eagerly.  warm(carry, t, Z)
    and main(carry, ii, Z) run one, storing its trace on the device: the
    warm-up's logπ at column t of `logpi_wu` (D, n_warm), the step's trace
    at column ii of `buf` (rows `names`, then D), read back a segment at a
    time (traces).  warm_iter and main_iter are the iterations themselves,
    with t and ii host ints or device indices (_GraphIterations captures
    them)."""

    def __init__(self, step, aux, consts, blur, D, C_l, n_warm, n_cols):
        self.step, self.aux, self.consts = step, aux, consts
        self.n_cols, self.D = n_cols, D
        self.shape = (D * C_l,) + tuple(blur.shape)
        self.dtype, self.device = blur.dtype, blur.device
        self.logpi_wu = torch.empty((D, n_warm), dtype=self.dtype, device=self.device)
        self.names = self.buf = None

    def begin(self) -> None:
        """Called as a run starts."""

    def warm_iter(self, carry, t, Z):
        carry, logpi = self.aux["warm_step"](carry, self.consts, Z)
        with span("sapg.trace"):
            _store(self.logpi_wu, t, logpi)
        return carry

    def main_iter(self, carry, ii, Z):
        carry, tr = self.step(carry, ii, self.consts, Z)
        with span("sapg.trace"):
            if self.buf is None:
                self.names = list(tr)
                self.buf = torch.empty((len(self.names), self.D, self.n_cols),
                                       dtype=self.dtype, device=self.device)
            _store(self.buf, ii, torch.stack([tr[n] for n in self.names]))
        return carry

    def warm(self, carry, t: int, Z):
        counters.add("graph.eager_steps")
        return self.warm_iter(carry, t, Z)

    def main(self, carry, ii: int, Z):
        counters.add("graph.eager_steps")
        return self.main_iter(carry, ii, Z)

    def traces(self, iis: range) -> dict:
        """The host copy of the traces of iterations iis, {name: (T, D)}
        (one read)."""
        if not len(iis):
            return {}
        host = self.buf[..., iis.start:iis.stop].cpu().numpy()
        return {n: host[i].T for i, n in enumerate(self.names)}


class _GraphIterations(_Iterations):
    """The iterations as CUDA graphs, one of a warm-up iteration and one of
    a SAPG iteration, captured once and replayed by the runs that follow
    (_run_for keeps them in the first problem's step_graphs).

    The graphs read and write static buffers: the carry (X, X̂, prox, and θ,
    σ² and the PSF parameters as rows of one (2 + P, D) block), the noise
    field Z and a device index a kind, which the graph advances.  A replay
    copies the new carry into the carry buffers as its last operations, so
    replays chain with no host work but the draw: the host calls the noise
    source, copies its field into Z and replays.  A carry handed in (the
    run's initial state, a checkpoint restored, fault_hook's) is copied
    into the buffers first; the carry handed out is the buffers, which the
    next replay overwrites.

    A kind's first iteration runs eagerly on the capture stream (the
    cuFFT plans, the cuBLAS workspace and the resident kernel's workspace
    for that stream are made there), then the graph is captured from the
    same function, under the `sapg.capture` span.  The wrappers' launch
    counts and sweep-count tensors reported during the capture are handed
    to the counters and the recorder once a replay (profiling.capturing,
    profiling.replayed).

    The step's all_reduce over a chains group stays out of the graphs: the
    capture ends a graph where the step calls it (aux["cuts"]) and goes on
    in the next, in the same memory pool, and a replay runs the graphs in
    turn with the all_reduce of the captured statistics between them,
    eagerly, as the eager step runs it.  On one device the step makes no
    cut and a kind is one graph."""

    def __init__(self, step, aux, consts, blur, D, C_l, n_warm, n_cols):
        super().__init__(step, aux, consts, blur, D, C_l, n_warm, n_cols)
        dtype, device, shape = self.dtype, self.device, self.shape
        self.stream = torch.cuda.Stream(device)
        X = torch.empty(shape, dtype=dtype, device=device)
        Xhat = torch.empty(shape[:-1] + (shape[-1] // 2 + 1,), dtype=blur.cdtype,
                           device=device)
        prox = torch.empty_like(X)
        self.param_names = list(aux["params0"])
        self.scal = torch.empty((2 + len(self.param_names), D), dtype=dtype, device=device)
        self.static = {
            "warm": (X, Xhat, prox),
            "main": (X, Xhat, prox, self.scal[0], self.scal[1],
                     {n: self.scal[2 + i] for i, n in enumerate(self.param_names)}),
        }
        self.Z = torch.empty_like(X)
        self.index = {k: torch.zeros((1,), dtype=torch.int64, device=device)
                      for k in self.static}
        self.fns = {"warm": self.warm_iter, "main": self.main_iter}
        self.graphs, self.next = {}, {}

    def begin(self) -> None:
        self.next = {}

    def warm(self, carry, t: int, Z):
        return self._iterate("warm", carry, t, Z)

    def main(self, carry, ii: int, Z):
        return self._iterate("main", carry, ii, Z)

    def _pairs(self, kind, carry):
        """(buffer, value) of each tensor of a carry."""
        static = self.static[kind]
        pairs = list(zip(static[:5], carry[:5]))
        if kind == "main":
            pairs += [(static[5][n], carry[5][n]) for n in self.param_names]
        return pairs

    def _iterate(self, kind, carry, i, Z):
        if kind not in self.graphs:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                carry = self.fns[kind](carry, i, Z)
            cur.wait_stream(self.stream)
            counters.add("graph.eager_steps")
            self._capture(kind)
            return carry
        for buf, value in self._pairs(kind, carry):
            if value is not buf:
                buf.copy_(value)
        if self.next.get(kind) != i:
            self.index[kind].fill_(i)
        self.Z.copy_(Z)
        pieces, sums, captured = self.graphs[kind]
        for k, graph in enumerate(pieces):
            graph.replay()
            if k < len(sums):
                self.aux["all_reduce"](sums[k])
        self.next[kind] = i + 1
        counters.add("graph.replays")
        profiling.replayed(captured)
        return self.static[kind]

    def _capture(self, kind) -> None:
        static, pool = self.static[kind], torch.cuda.graph_pool_handle()
        pieces, sums = [], []

        def begin():
            pieces.append(torch.cuda.CUDAGraph())
            pieces[-1].capture_begin(pool=pool, capture_error_mode="thread_local")

        def cut(packed):
            pieces[-1].capture_end()
            sums.append(packed)
            begin()

        with span("sapg.capture"), profiling.capturing() as captured, \
                torch.cuda.stream(self.stream):
            self.aux["cuts"].append(cut)
            try:
                begin()
                out = self.fns[kind](static, self.index[kind], self.Z)
                for buf, value in zip(static[:3], out[:3]):
                    buf.copy_(value)
                if kind == "main":
                    torch.stack([out[3], out[4]] + [out[5][n] for n in self.param_names],
                                out=self.scal)
                self.index[kind].add_(1)
            except BaseException:
                try:
                    pieces[-1].capture_end()
                except RuntimeError:
                    pass   # the capture was invalidated by the error raised
                raise
            finally:
                self.aux["cuts"].pop()
            pieces[-1].capture_end()
        counters.add("graph.captures")
        self.graphs[kind] = (pieces, sums, captured)


class SAPGRun:
    """A rank's share of a SAPG run of D problems × C chains on `layout`
    (parallel/mesh.RankLayout): the problem-batched step of its problems
    and its rows of their chains, the step's iterations, the noise draws,
    the warm-up, the main scan's segments and its problems' results.
    `warmup` and `samples` override cfg.sapg's (the bare stepper passes 1
    and its step count: no warm-up iterations).  `graphs`: the iterations
    replay as CUDA graphs (_GraphIterations) where resolve_graph_replay
    holds for the step, else they run eagerly."""

    def __init__(self, problems: Sequence[Problem], layout: RankLayout,
                 route: Optional[str] = None, warmup: Optional[int] = None,
                 samples: Optional[int] = None, graphs: bool = False):
        p0 = problems[0]
        for p in problems:
            if p.device != layout.device:
                raise ValueError(f"problem on {p.device}, this rank's device is {layout.device}")
        self.problems, self.layout, self.route = list(problems), layout, route
        self.cfg, self.blur = p0.cfg, p0.blur
        self.shape = tuple(self.blur.shape)
        self.chains = layout.rows.stop - layout.rows.start   # C_l, the rank's of a problem
        self.n_chains = self.chains * layout.n_group          # C
        D = len(layout.problems)
        sapg = self.cfg.sapg
        self.n_warm = max((sapg.warmup if warmup is None else warmup) - 1, 0)
        self.step, self.aux = make_general_sapg_step(
            p0.model, self.blur, self.cfg, sigma_fix=p0.sigma_spec().fix, route=route,
            problems=D, chains_group=layout.group,
        )
        self.consts = problem_consts([problems[d] for d in layout.problems])
        graphs = graphs and resolve_graph_replay(sapg, self.aux["route"], self.blur.fft_mode,
                                                 layout.device, self.shape, self.chains)
        self.iterations = (_GraphIterations if graphs else _Iterations)(
            self.step, self.aux, self.consts, self.blur, D, self.chains, self.n_warm,
            (sapg.samples if samples is None else samples) + 1)

    def init_x(self, x0=None) -> torch.Tensor:
        """X0 (D·C_l, M, N): each problem's y (op.X0's default,
        SAPG_algorithm_Guassian.m:10-12), or x0 for every problem."""
        D = len(self.layout.problems)
        if x0 is None:
            ys = torch.stack([self.problems[d].y for d in self.layout.problems])
        else:
            ys = torch.as_tensor(x0, dtype=self.blur.dtype, device=self.layout.device)
            ys = ys.expand((D,) + self.shape)
        return ys[:, None].expand((D, self.chains) + self.shape).reshape(
            (D * self.chains,) + self.shape).contiguous()

    def start(self, X):
        """The warm-up's first carry (X, X̂, prox) from X; the initial prox
        (A2 on the card) takes λθ₀ of each problem."""
        lam_theta = self.aux["chains_of"](self.consts["lam"] * self.aux["theta0"], self.chains)
        return X, self.blur.rfft(X), self.aux["prox_b"](X, lam_theta)[0]

    def draws(self, generators=None, noise=None, seeds=None):
        """(draw, the generators drawn from): draw() is one step's noise for
        the rank's chains, each of its problems' whole field (or seeds), its
        rows kept, from the problem's source: noise[d]((C, M, N)) or
        seeds[d](C), else normals (seeds) from generators[d] (one
        torch.Generator for one problem will do).  Seeds or normals as the
        step's rule picks them for one problem's chains on the rank."""
        layout, C = self.layout, self.n_chains
        shape = (C,) + self.shape
        gens = [generators] if isinstance(generators, torch.Generator) else list(generators or [])
        if gens and len(gens) != len(self.problems):
            raise ValueError(f"{len(gens)} generators for {len(self.problems)} problems")
        ikr = self.aux["in_kernel_rng"](self.chains)
        user = seeds if ikr else noise
        sources, drawn_from = [], []
        for d in layout.problems:
            if user is not None:
                src = user[d]
            else:
                g = gens[d] if gens else None
                if g is None:
                    raise ValueError("a SAPG run needs a generator or a "
                                     f"{'seed' if ikr else 'noise'} source for each problem")
                drawn_from.append(g)
                src = (generator_seeds(g, layout.device) if ikr
                       else generator_noise(g, self.blur.dtype, layout.device))
            sources.append((lambda s=src: s(C)) if ikr else (lambda s=src: s(shape)))

        def kept(field):
            """The rank's rows of a problem's whole field; counts the
            elements drawn and kept (`noise.drawn`, `noise.kept`)."""
            part = field[layout.rows]
            counters.add("noise.drawn", field.numel())
            counters.add("noise.kept", part.numel())
            return part

        def draw():
            parts = [src() if layout.n_group == 1 else kept(src()) for src in sources]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        return draw, drawn_from

    def warm(self, carry, draw):
        """Warm-up (SAPG_algorithm_Guassian.m:67-93) from start's carry:
        (the main scan's first carry, logpi_wu (n_warm, D), logpi0 (D,))."""
        its, aux = self.iterations, self.aux
        with span("sapg.warmup"):
            for t in range(self.n_warm):
                with span("sapg.warm_step"):
                    with span("sapg.noise"):
                        Z = draw()
                    carry = its.warm(carry, t, Z)
            X, Xhat, _ = carry
            # logPiTraceX(1): logPi at the warm-start sample with the init params
            logpi0 = aux["logpi_init"](Xhat, aux["tv_b"](X), self.consts)
            return aux["main_carry"](carry, self.consts), its.logpi_wu.T, logpi0

    def scan(self, carry, iis, draw):
        """The main iterations iis (a range); host traces {name: (T, D)},
        read back once."""
        with span("sapg.segment"):
            for ii in iis:
                with span("sapg.step"):
                    with span("sapg.noise"):
                        Z = draw()
                    carry = self.iterations.main(carry, ii, Z)
            return carry, self.iterations.traces(iis)

    def gather_chains(self, v: np.ndarray) -> np.ndarray:
        """(D·C_l, M, N) of this rank → (D, C, M, N), the chains of the
        group's ranks in chains order."""
        shape = (len(self.layout.problems), self.chains) + v.shape[1:]
        if self.layout.group is None:
            return v.reshape(shape)
        parts = [None] * self.layout.n_group
        with span("sapg.gather"):
            dist.all_gather_object(parts, v, group=self.layout.group)
            return np.concatenate([p.reshape(shape) for p in parts], axis=1)

    def gather_data(self, items: list) -> list:
        """The per-problem items of every data index, in problem order."""
        group = self.layout.data_group
        if group is None:
            return items
        parts = [None] * dist.get_world_size(group)
        with span("sapg.gather"):
            dist.all_gather_object(parts, items, group=group)
        return [x for p in parts for x in p]

    def assemble(self, carry, traces, logpi_wu, logpi0, exec_time: float) -> List[SAPGResult]:
        """Every problem's SAPGResult, on every rank: the chains' final
        states gathered over the chains group, the problems over the data
        group."""
        logpi_wu, logpi0 = _host(logpi_wu), _host(logpi0)
        X_all = self.gather_chains(_host(carry[0]))
        extra = carry[6] if len(carry) > 6 else {}
        moments = {k: self.gather_chains(_host(v)) for k, v in extra.items() if k != "pm_count"}
        results = []
        for i, d in enumerate(self.layout.problems):
            extra_d = {k: v[i] for k, v in moments.items()}
            if extra:
                extra_d["pm_count"] = extra["pm_count"]
            results.append(assemble_result(
                self.problems[d], self.aux["psf_names"], {k: v[:, i] for k, v in traces.items()},
                logpi_wu[:, i] if self.n_warm > 0 else np.zeros(0), float(logpi0[i]),
                X_all[i], extra_d, exec_time,
            ))
        return self.gather_data(results)


def _run_for(problems, layout: RankLayout, route: Optional[str], graphs: bool) -> SAPGRun:
    """The SAPGRun of a run: where its iterations replay as CUDA graphs,
    the one kept in the first problem's step_graphs for these problems,
    layout and route (a new one kept there in place of any other), else a
    new one."""
    kept = problems[0].step_graphs.get("run") if graphs else None
    if kept is not None and kept.layout == layout and kept.route == route \
            and len(kept.problems) == len(problems) \
            and all(a is b for a, b in zip(kept.problems, problems)):
        run = kept
    else:
        run = SAPGRun(problems, layout, route, graphs=graphs)
        if isinstance(run.iterations, _GraphIterations):
            problems[0].step_graphs.clear()
            problems[0].step_graphs["run"] = run
    run.iterations.begin()
    return run


def run_sapg_layout(
    problems: Sequence[Problem],
    layout: RankLayout,
    generators=None,
    x0=None,
    noise: Optional[Sequence[Callable]] = None,
    seeds: Optional[Sequence[Callable]] = None,
    route: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_backend: str = "npz",
    fault_hook=None,
    nan_guard: bool = True,
    max_restores: int = 1,
    _graphs: bool = True,
) -> List[SAPGResult]:
    """The SAPG run loop (SAPG_algorithm_Guassian.m:67-306): warm-up, main
    scan with the full trace bundle, per-problem EB extraction through
    assemble_result, posterior moments, mid-run checkpoint/resume and the
    NaN guard through run_segmented_scan, for the rank's share of
    `problems` on `layout`; one SAPGResult per problem, on every rank.
    run_sapg runs one problem on one device (or a mesh) through it, and
    parallel/sapg_parallel.run_sapg_sharded a mesh's problems; their
    docstrings describe the arguments (generators, noise and seeds one a
    problem).  A world of more than one process checkpoints to a directory
    (checkpoint_backend "orbax"), every rank writing its own arrays."""
    if layout.rank is not None and dist.get_world_size() > 1 and checkpoint_backend == "npz" \
            and checkpoint_path is not None:
        raise ValueError("a multi-process run checkpoints to a directory: "
                         "checkpoint_backend='orbax'")
    with span("sapg.run"):
        with span("sapg.prologue"):
            run = _run_for(problems, layout, route, _graphs)
            draw, gens = run.draws(generators, noise, seeds)
            t0 = time.perf_counter()
            resume = checkpoint_path is not None and os.path.exists(checkpoint_path)
            logpi = {}
            if not resume:
                carry = run.start(run.init_x(x0))
        if resume:
            carry = None   # restore_fn supplies it, with the warm-up trace
        else:
            carry, logpi["wu"], logpi["0"] = run.warm(carry, draw)

        def restore():
            carry, done, traces, logpi["wu"], logpi["0"] = _restore_checkpoint(
                checkpoint_path, layout, gens, checkpoint_backend, run.blur.rfft)
            return carry, done, traces

        def save(carry, done, seg_traces):
            _save_checkpoint(checkpoint_path, layout, carry, done, seg_traces, logpi["wu"],
                             logpi["0"], gens, checkpoint_backend)

        carry, seg_traces = run_segmented_scan(
            lambda c, iis: run.scan(c, iis, draw), carry, run.cfg.sapg.samples,
            checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path, save_fn=save,
            restore_fn=restore, fault_hook=fault_hook, nan_guard=nan_guard,
            max_restores=max_restores,
        )
        with span("sapg.assemble"):
            if layout.device.type == "cuda":
                torch.cuda.synchronize(layout.device)
            exec_time = time.perf_counter() - t0
            fold_sweeps()
            traces = _merge_traces(seg_traces) if seg_traces else {}
            return run.assemble(carry, traces, logpi["wu"], logpi["0"], exec_time)


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
