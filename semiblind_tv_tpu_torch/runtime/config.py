"""Typed configuration tree with per-demo presets.

Field for field the port of `semiblind_tv_tpu/runtime/config.py` (the
reference's `op` and `c` structs, run_Gaussian_demo.m:34-89): same names,
same defaults, same presets and the same deliberate reference quirks (the
Laplace demo's 10x gamma and lambdaMax=0.1, its `max` Lipschitz
aggregation).  Options of the JAX package that only select TPU code paths
keep their fields so configurations compare equal; the port's estimator
raises `NotImplementedError` for the two it does not run
(`fft_precision='high'`, a TPU bf16 workaround, and
`track_posterior_moments`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from semiblind_tv_tpu_torch.models.psf_models import ParamSpec

__all__ = [
    "SAPGConfig",
    "SALSAConfig",
    "DemoConfig",
    "gaussian_preset",
    "laplace_preset",
    "moffat_preset",
    "isotropic_preset",
    "preset",
]


@dataclasses.dataclass(frozen=True)
class SAPGConfig:
    """SAPG + MYULA loop configuration (reference `op` struct)."""

    samples: int = 20_000           # op.samples
    warmup: int = 15_000            # op.warmup
    burn_in: Optional[int] = None   # op.burnIn; default = 80% of samples
    lambda_max: float = 2.0         # op.lambdaMax
    gamma_frac: float = 0.98        # op.gammaFrac
    gamma_multiplier: float = 1.0   # Laplace demo multiplies gamma by 10
    d_exp: float = 0.8              # op.d_exp
    d_scale: Optional[float] = None  # op.d_scale; default = 0.01 / theta.init
    chambolle_iters: int = 25       # chambolleit (run_Gaussian_demo.m:188)
    chambolle_tau: float = 0.249
    chambolle_tol: float = 1e-3
    stop_tol: float = 1e-5          # op.stopTol — recorded, never triggers a stop
    lipschitz_agg: str = "min"      # min (Gaussian/Moffat) or max (Laplace)
    lambda_scale: float = 1.0       # c.lam (run_Gaussian_demo.m:38)
    gamma_scale: float = 1.0        # c.gam (run_Gaussian_demo.m:39)
    use_pallas_prox: bool = False   # JAX name kept: the SAPG prox takes the
                                    # Chambolle kernel (always the case on a
                                    # CUDA tensor in the port)
    fft_mode: Optional[str] = None  # 'fft' (torch.fft, cuFFT) or 'dft' (dense
                                    # DFT matmuls, ops/fourier.py); None:
                                    # 'fft' on every device
    use_fused_step: Optional[bool] = None
                                    # None/True: MYULA + prox + TV through
                                    # ops/fused_step_cuda.myula_prox_tv;
                                    # False: MYULA step, then the prox kernel
                                    # (ops/tv_cuda) and tv_norm separately
    fft_precision: Optional[str] = None  # port: full fp32 always; 'high' raises
    fuse_dft: Optional[bool] = None  # dft mode, route B: the whole-iteration
                                    # kernel D (ops/fused_dft_cuda); None: on
                                    # at ≤256² with ≤2 chains
    fuse_irdft: bool = False        # dft mode, route B, no fuse_dft and no
                                    # in_kernel_rng: kernel E (D without the
                                    # forward transform); the warm-up keeps B
    in_kernel_rng: bool = False     # noise drawn in the step kernel from
                                    # per-chain seeds: kernel C on route B, I's
                                    # seeds form on route I; off elsewhere
    track_traces: bool = True       # record per-iteration diagnostics
    theta_log_scale: bool = False   # Algorithm-1 log-θ updates
    positivity: bool = True         # abs() projection in the MYULA step
    sigma_log_scale: bool = False   # log-space σ² updates (extension)
    psf_log_scale: bool = False     # log-space PSF-parameter updates (extension)
    track_posterior_moments: bool = False  # not ported (raises when True)

    @property
    def burn_in_resolved(self) -> int:
        return self.burn_in if self.burn_in is not None else (self.samples * 80) // 100


@dataclasses.dataclass(frozen=True)
class SALSAConfig:
    """SALSA MAP-solve configuration (run_Gaussian_demo.m:219-242)."""

    outer_iters: int = 500
    tol: float = 1e-5
    stop_criterion: int = 1     # 1: rel-Δobjective, 2: rel-Δx, 3: objective target
    tv_iters: int = 10
    mu_factor: float = 0.1      # mu = theta_EB * mu_factor
    use_pallas_prox: Optional[bool] = None  # JAX name kept; the port routes
                                # by tensor device (kernel on CUDA)


@dataclasses.dataclass(frozen=True)
class DemoConfig:
    """Full experiment description — one reference demo script."""

    psf: str                          # 'gaussian' | 'laplace' | 'moffat'
    psf_size: int = 7
    phi: float = 0.0
    bsnr: float = 30.0
    bsnr_min: float = 15.0
    bsnr_max: float = 45.0
    theta: ParamSpec = ParamSpec(
        name="theta", init=0.01, box=(1e-3, 1.0), step_scale=0.01, sign=+1.0
    )
    sigma_step_scale: float = 1000.0
    fix_sigma: bool = False
    psf_params: Tuple[ParamSpec, ...] = ()
    sapg: SAPGConfig = SAPGConfig()
    salsa: SALSAConfig = SALSAConfig()
    image: str = "wheel"              # demos default to testImg{8} = wheel.png
    seed: int = 1

    def true_psf_params(self) -> Dict[str, float]:
        return {s.name: s.true_value for s in self.psf_params}

    def init_psf_params(self) -> Dict[str, float]:
        # When a parameter is fixed, the demo scripts overwrite its init with the
        # true value (run_Gaussian_demo.m:102-107, run_laplace_demo.m:77-79).
        return {
            s.name: (s.true_value if s.fix else s.init) for s in self.psf_params
        }


def gaussian_preset(
    fix_w1: bool = True,
    fix_w2: bool = True,
    fix_sigma: bool = False,
    w1: float = 0.4,
    w2: float = 0.3,
    **overrides,
) -> DemoConfig:
    """run_Gaussian_demo.m:32-89 (defaults fix_w1=fix_w2=1, fix_sigma=0)."""
    return DemoConfig(
        psf="gaussian",
        theta=ParamSpec("theta", init=0.01, box=(1e-3, 1.0), step_scale=0.01, sign=+1.0),
        sigma_step_scale=1000.0,
        fix_sigma=fix_sigma,
        psf_params=(
            ParamSpec("w1", init=0.5, box=(0.1, 1.0), step_scale=10.0, fix=fix_w1, true_value=w1),
            ParamSpec("w2", init=0.3, box=(0.1, 1.0), step_scale=10.0, fix=fix_w2, true_value=w2),
        ),
        sapg=SAPGConfig(lambda_max=2.0, lipschitz_agg="min"),
        **overrides,
    )


def laplace_preset(
    fix_b: bool = False, fix_sigma: bool = False, b: float = 0.3, **overrides
) -> DemoConfig:
    """run_laplace_demo.m:34-80 (lambdaMax=0.1, gamma 10x, Lf via max)."""
    return DemoConfig(
        psf="laplace",
        theta=ParamSpec("theta", init=0.01, box=(1e-3, 1.0), step_scale=0.01, sign=+1.0),
        sigma_step_scale=10_000.0,
        fix_sigma=fix_sigma,
        psf_params=(
            ParamSpec("b", init=0.1, box=(1e-3, 1.0), step_scale=100.0, fix=fix_b, true_value=b),
        ),
        sapg=SAPGConfig(lambda_max=0.1, gamma_multiplier=10.0, lipschitz_agg="max"),
        **overrides,
    )


def moffat_preset(
    fix_alpha: bool = False,
    fix_beta: bool = False,
    fix_sigma: bool = False,
    alpha: float = 0.4,
    beta: float = 3.5,
    **overrides,
) -> DemoConfig:
    """run_moffat_demo.m:33-84 (BSNR range [18, 35], c_theta=0.1)."""
    return DemoConfig(
        psf="moffat",
        bsnr_min=18.0,
        bsnr_max=35.0,
        theta=ParamSpec("theta", init=0.01, box=(1e-3, 1.0), step_scale=0.1, sign=+1.0),
        sigma_step_scale=10_000.0,
        fix_sigma=fix_sigma,
        psf_params=(
            ParamSpec("alpha", init=1.0, box=(1e-2, 1.0), step_scale=10.0, fix=fix_alpha, true_value=alpha),
            ParamSpec("beta", init=10.0, box=(0.1, 10.0), step_scale=10_000.0, fix=fix_beta, true_value=beta),
        ),
        sapg=SAPGConfig(lambda_max=2.0, lipschitz_agg="min"),
        **overrides,
    )


def isotropic_preset(
    fix_w: bool = False, w: float = 0.5, **overrides
) -> DemoConfig:
    """SIAM 4.2.1 capability: isotropic Gaussian with one unknown width,
    Algorithm-1 style SAPG (log-theta, no positivity projection), sigma²
    pinned.  The port has the configuration and the log-theta updates but
    not yet its PSF family (`build_problem` raises)."""
    return DemoConfig(
        psf="isotropic_gaussian",
        theta=ParamSpec("theta", init=0.01, box=(1e-3, 1.0), step_scale=1.0, sign=+1.0),
        sigma_step_scale=0.0,
        fix_sigma=True,
        psf_params=(
            ParamSpec("w", init=0.8, box=(0.1, 2.0), step_scale=1.0, fix=fix_w, true_value=w),
        ),
        sapg=SAPGConfig(
            lambda_max=2.0, lipschitz_agg="min",
            theta_log_scale=True, positivity=False,
        ),
        **overrides,
    )


_PRESETS = {
    "gaussian": gaussian_preset,
    "laplace": laplace_preset,
    "moffat": moffat_preset,
    "isotropic_gaussian": isotropic_preset,
}


def preset(name: str, **kwargs) -> DemoConfig:
    return _PRESETS[name](**kwargs)
