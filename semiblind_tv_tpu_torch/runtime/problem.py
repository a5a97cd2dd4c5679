"""Problem assembly: observation synthesis and derived algorithm constants
(port of `semiblind_tv_tpu/runtime/problem.py`, run_Gaussian_demo.m:122-195).

  * BSNR-controlled noise: sigma = ||Ax − mean(Ax)||_F / sqrt(d·10^(BSNR/10))
  * sigma² box from [BSNR_min, BSNR_max]
  * Lf = evMax² / sigma² with evMax = max|H|² (closed form), aggregated over
    the two ends of the box by min (Gaussian/Moffat) or max (Laplace)
  * lambda = min(5/Lf, lambdaMax), gamma = gammaMult·gammaFrac / (Lf + 1/lambda)

Every scalar stays a 0-d tensor on the problem's device, so the SAPG loop
never copies one to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from semiblind_tv_tpu_torch.models.psf_models import (
    GaussianPsfModel,
    LaplacePsfModel,
    MoffatPsfModel,
    ParamSpec,
    PsfModel,
)
from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.lipschitz import max_eigenval_closed_form
from semiblind_tv_tpu_torch.runtime.config import DemoConfig

__all__ = [
    "Problem", "build_problem", "synthesize_observation", "make_psf_model",
    "problem_from_arrays", "resolve_fft_mode", "resolve_device",
]


def make_psf_model(cfg: DemoConfig, dtype=torch.float32) -> PsfModel:
    if cfg.psf == "gaussian":
        return GaussianPsfModel(cfg.psf_size, cfg.phi, dtype)
    if cfg.psf == "laplace":
        return LaplacePsfModel(cfg.psf_size, dtype)
    if cfg.psf == "moffat":
        return MoffatPsfModel(cfg.psf_size, dtype)
    if cfg.psf == "isotropic_gaussian":
        raise NotImplementedError("the isotropic Gaussian family is not ported yet")
    raise ValueError(f"unknown psf family: {cfg.psf!r}")


def resolve_device(device) -> torch.device:
    """The requested device; raises if it is CUDA and no card is present
    (the entry points default to the card and never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return device


def resolve_fft_mode(fft_mode: Optional[str]) -> str:
    """The transform mode: 'fft' for None on every device (the JAX
    package's TPU auto-policy, dft up to 512², is not ported); an explicit
    'fft' or 'dft' is honoured."""
    if fft_mode is None:
        return "fft"
    if fft_mode not in ("fft", "dft"):
        raise ValueError(f"fft_mode must be 'fft' or 'dft', got {fft_mode!r}")
    return fft_mode


def _sigma_for_bsnr(Ax, d, bsnr):
    return torch.linalg.norm(Ax - torch.mean(Ax)) / math.sqrt(d * 10.0 ** (bsnr / 10.0))


def synthesize_observation(x, H, blur: BlurOperator, bsnr, generator=None, noise=None):
    """y = A x + sigma·noise with BSNR-controlled sigma
    (run_Gaussian_demo.m:144-168).  `noise` (a standard-normal field) is
    drawn from `generator` unless given."""
    Ax = blur.apply(x, H)
    sigma = _sigma_for_bsnr(Ax, x.numel(), bsnr)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    elif not torch.is_tensor(noise):
        noise = torch.tensor(np.asarray(noise))
    y = Ax + sigma * noise.to(dtype=x.dtype, device=x.device)
    return y, sigma, Ax


@dataclasses.dataclass
class Problem:
    """A fully-assembled semi-blind deblurring problem instance."""

    cfg: DemoConfig
    model: PsfModel
    blur: BlurOperator
    x_true: torch.Tensor
    y: torch.Tensor
    yhat: torch.Tensor             # rfft2(y), for the SAPG step
    H_true: torch.Tensor
    kernel_true: torch.Tensor
    sigma_true: torch.Tensor       # noise std used to synthesize y
    sigma2_init: torch.Tensor
    sigma2_box: tuple              # (min, max) 0-d tensors: projection box of sigma²
    ev_max: torch.Tensor
    Lf: torch.Tensor
    lambda_myula: torch.Tensor
    gamma: torch.Tensor
    gamma_max: torch.Tensor

    @property
    def dim(self) -> int:
        return self.x_true.numel()

    @property
    def device(self) -> torch.device:
        return self.x_true.device

    def sigma_spec(self) -> ParamSpec:
        """ParamSpec for sigma² with the BSNR-derived box (host values)."""
        return ParamSpec(
            name="sigma2",
            init=float(self.sigma2_init),
            box=(float(self.sigma2_box[0]), float(self.sigma2_box[1])),
            step_scale=self.cfg.sigma_step_scale,
            sign=+1.0,
            fix=self.cfg.fix_sigma,
            true_value=float(self.sigma2_init) if self.cfg.fix_sigma else None,
        )


def _derived(cfg: DemoConfig, ev_max, s_a, s_b, sigma):
    """sigma² box and init, Lf, MYULA λ and γ from evMax and the BSNR ends."""
    s_min = torch.minimum(s_a, s_b)
    s_max = torch.maximum(s_a, s_b)
    sigma2_init = sigma ** 2 if cfg.fix_sigma else (s_a + s_b) / 2.0
    lf_a = ev_max ** 2 / s_a
    lf_b = ev_max ** 2 / s_b
    agg = torch.minimum if cfg.sapg.lipschitz_agg == "min" else torch.maximum
    Lf = agg(lf_a, lf_b)
    lam = cfg.sapg.lambda_scale * torch.clamp(5.0 / Lf, max=cfg.sapg.lambda_max)
    gamma_max = 1.0 / (Lf + 1.0 / lam)
    gamma = (
        cfg.sapg.gamma_scale * cfg.sapg.gamma_multiplier * cfg.sapg.gamma_frac * gamma_max
    )
    return dict(s_min=s_min, s_max=s_max, sigma2_init=sigma2_init, Lf=Lf, lam=lam,
                gamma_max=gamma_max, gamma=gamma)


def build_problem(
    x,
    cfg: DemoConfig,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
    device="cuda",
    noise=None,
    fft_mode: Optional[str] = None,
) -> Problem:
    """Assemble a Problem from a ground-truth image and a DemoConfig.

    The observation noise is drawn from `generator` (which must live on
    `device`: the card unless the caller asks for the CPU), or given as
    `noise`, a standard-normal field of x's shape.
    fft_mode (default cfg.sapg.fft_mode, through resolve_fft_mode) selects
    the blur operator's transforms, the observation's included, as in the
    JAX package."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x), dtype=dtype).to(device)
    model = make_psf_model(cfg, dtype)
    mode = resolve_fft_mode(cfg.sapg.fft_mode if fft_mode is None else fft_mode)
    blur = BlurOperator(x.shape, cfg.psf_size, dtype, device, fft_mode=mode)
    d = x.numel()

    true_params = {
        k: torch.tensor(v, dtype=dtype, device=device) for k, v in cfg.true_psf_params().items()
    }
    kernel_true = model.kernel(true_params)
    H = blur.otf(kernel_true)
    ev_max = max_eigenval_closed_form(H)
    y, sigma, Ax = synthesize_observation(x, H, blur, cfg.bsnr, generator, noise)
    s_a = _sigma_for_bsnr(Ax, d, cfg.bsnr_min) ** 2   # larger noise
    s_b = _sigma_for_bsnr(Ax, d, cfg.bsnr_max) ** 2   # smaller noise
    D = _derived(cfg, ev_max, s_a, s_b, sigma)

    return Problem(
        cfg=cfg,
        model=model,
        blur=blur,
        x_true=x,
        y=y,
        yhat=blur.rfft_host(y),
        H_true=blur.otf_host(kernel_true),
        kernel_true=kernel_true,
        sigma_true=sigma,
        sigma2_init=D["sigma2_init"],
        sigma2_box=(D["s_min"], D["s_max"]),
        ev_max=ev_max,
        Lf=D["Lf"],
        lambda_myula=D["lam"],
        gamma=D["gamma"],
        gamma_max=D["gamma_max"],
    )


def problem_from_arrays(cfg: DemoConfig, arrays: Dict[str, np.ndarray], device="cuda",
                        dtype=torch.float32, fft_mode: Optional[str] = None) -> Problem:
    """The port's Problem from the fields of the JAX package's Problem, given
    as numpy arrays (x_true, y, yhat, H_true, kernel_true, sigma_true,
    sigma2_init, sigma2_box, ev_max, Lf, lambda_myula, gamma; gamma_max is
    derived when absent), so the two packages compute on the same problem.
    fft_mode is the JAX Problem's `blur.fft_mode` (default: resolved from
    cfg.sapg.fft_mode); in 'dft' mode the rdft matrices are rebuilt.  The
    problem lives on the card unless `device` asks for the CPU."""
    device = resolve_device(device)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64

    def real(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)

    def cplx(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=cdtype, device=device)

    x = real("x_true")
    lam = real("lambda_myula")
    Lf = real("Lf")
    gamma_max = real("gamma_max") if "gamma_max" in arrays else 1.0 / (Lf + 1.0 / lam)
    lo, hi = (torch.tensor(np.asarray(v), dtype=dtype, device=device)
              for v in arrays["sigma2_box"])
    return Problem(
        cfg=cfg,
        model=make_psf_model(cfg, dtype),
        blur=BlurOperator(x.shape, cfg.psf_size, dtype, device, fft_mode=resolve_fft_mode(
            cfg.sapg.fft_mode if fft_mode is None else fft_mode)),
        x_true=x,
        y=real("y"),
        yhat=cplx("yhat"),
        H_true=cplx("H_true"),
        kernel_true=real("kernel_true"),
        sigma_true=real("sigma_true"),
        sigma2_init=real("sigma2_init"),
        sigma2_box=(lo, hi),
        ev_max=real("ev_max"),
        Lf=Lf,
        lambda_myula=lam,
        gamma=real("gamma"),
        gamma_max=gamma_max,
    )
