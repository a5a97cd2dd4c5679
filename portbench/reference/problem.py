"""The observation and the constants the demos derive from it
(run_Gaussian_demo.m:122-195), worked out from the image, the
configuration's numbers and a standard-normal field.

    y = A x + σ·n,  σ = ‖Ax − mean(Ax)‖_F / √(d·10^(BSNR/10))
    σ² box from [BSNR_min, BSNR_max], its midpoint the initial σ²
    Lf = max|H|⁴ / σ²_end, the min (Gaussian, Moffat) of the two box ends
    λ = min(5/Lf, λmax),  γ = γmult·γfrac / (Lf + 1/λ)

Scalars are 0-d tensors of the fields' dtype on their device.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import psf


def _sigma(Ax, bsnr):
    return torch.linalg.norm(Ax - Ax.mean()) / math.sqrt(Ax.numel() * 10.0 ** (bsnr / 10.0))


def true_params(demo, dtype, device):
    return {p["name"]: torch.tensor(p["true"], dtype=dtype, device=device)
            for p in demo["psf_params"]}


def init_params(demo, dtype, device):
    """The SA's starting point: a fixed parameter starts (and stays) at its
    true value (run_Gaussian_demo.m:102-107)."""
    return {p["name"]: torch.tensor(p["true"] if p["fix"] else p["init"], dtype=dtype,
                                    device=device) for p in demo["psf_params"]}


def build(image, demo, obs_noise):
    """dict(x, y, yhat, H, sigma, sigma2_init, sigma2_lo, sigma2_hi, lam, gamma)
    for an (M, N) image; obs_noise is the standard-normal field of y, on the
    device and in the dtype the reference computes in."""
    dtype, device = obs_noise.dtype, obs_noise.device
    x = torch.as_tensor(image).to(device=device, dtype=dtype)
    k, _ = psf.kernel_and_grads(demo, true_params(demo, dtype, device), dtype, device)
    H = psf.otf(k, x.shape)
    Ax = torch.fft.irfft2(H * torch.fft.rfft2(x), s=x.shape)
    sigma = _sigma(Ax, demo["bsnr"])
    y = Ax + sigma * obs_noise
    s_a = _sigma(Ax, demo["bsnr_min"]) ** 2
    s_b = _sigma(Ax, demo["bsnr_max"]) ** 2
    ev = torch.max(H.real ** 2 + H.imag ** 2)
    agg = {"min": torch.minimum, "max": torch.maximum}[demo["lipschitz_agg"]]
    Lf = agg(ev ** 2 / s_a, ev ** 2 / s_b)
    lam = torch.clamp(5.0 / Lf, max=demo["lambda_max"])
    gamma = demo["gamma_multiplier"] * demo["gamma_frac"] / (Lf + 1.0 / lam)
    return dict(x=x, y=y, yhat=torch.fft.rfft2(y), H=H, sigma=sigma,
                sigma2_init=(s_a + s_b) / 2.0, sigma2_lo=torch.minimum(s_a, s_b),
                sigma2_hi=torch.maximum(s_a, s_b), lam=lam, gamma=gamma)
