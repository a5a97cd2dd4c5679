"""Parametric PSF families (Gaussian / Laplace / Moffat) and their analytic
parameter gradients — the port of `semiblind_tv_tpu/ops/psf.py`.

All kernels are normalised to sum to one; the gradient of the normalised
kernel follows the quotient rule d(k/S)/dp = (dk·S − k·dS)/S², exactly as
the reference computes it (utils/Sum_gauss_psf.m, sum_lap_psf.m,
sum_mof_psf.m).

Parameters may be Python floats or tensors of any shape `P`; the result has
shape `P + (size, size)`, so a trace of parameters gives a stack of kernels
in one call.  The device is that of the first tensor parameter (CPU when all
are floats), unless `device` is given.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "psf_grid",
    "gaussian_kernel",
    "gaussian_kernel_grads",
    "laplace_kernel",
    "laplace_kernel_grads",
    "moffat_kernel",
    "moffat_kernel_grads",
]


def _params(dtype, device, *ps):
    """Params as tensors with two trailing unit dims (broadcast over the grid)."""
    if device is None:
        device = next((p.device for p in ps if torch.is_tensor(p)), torch.device("cpu"))
    out = [torch.as_tensor(p, dtype=dtype, device=device)[..., None, None] for p in ps]
    return device, out


def _sum2(a):
    return torch.sum(a, dim=(-2, -1), keepdim=True)


def psf_grid(size: int, dtype=torch.float32, device=None):
    """Centered integer offset grid (v, u) for an odd `size` x `size` kernel:
    v varies along rows, u along columns (utils/Gaussian_psf.m:8)."""
    offs = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    v = offs[:, None] * torch.ones((1, size), dtype=dtype, device=device)
    u = torch.ones((size, 1), dtype=dtype, device=device) * offs[None, :]
    return v, u


# ---------------------------------------------------------------------------
# Gaussian (anisotropic, rotated):  k ∝ (w1 w2 / 2π) exp(-(w1²U² + w2²V²)/2)
# ---------------------------------------------------------------------------

def _gaussian_unnormalised(size, w1, w2, phi, dtype, device):
    device, (w1, w2) = _params(dtype, device, w1, w2)
    v, u = psf_grid(size, dtype, device)
    # a fill, not a host-to-device copy: the SAPG step runs this every
    # iteration, and a CUDA graph cannot capture such a copy
    phi_t = (phi.to(dtype=dtype, device=device) if torch.is_tensor(phi)
             else torch.full((), phi, dtype=dtype, device=device))
    cphi, sphi = torch.cos(phi_t), torch.sin(phi_t)
    U = u * cphi - v * sphi
    V = u * sphi + v * cphi
    c = w1 ** 2 * U ** 2 + w2 ** 2 * V ** 2
    e = torch.exp(-c / 2.0)
    f = (w1 * w2) / (2.0 * math.pi) * e
    return f, e, U, V, w1, w2


def gaussian_kernel(size: int, w1, w2, phi=0.0, dtype=torch.float32, device=None):
    """Normalised anisotropic rotated Gaussian PSF (reference Gaussian_psf.m)."""
    f = _gaussian_unnormalised(size, w1, w2, phi, dtype, device)[0]
    return f / _sum2(f)


def gaussian_kernel_grads(size: int, w1, w2, phi=0.0, dtype=torch.float32, device=None):
    """(kernel, dk/dw1, dk/dw2) of the normalised Gaussian PSF
    (diff_fftgaus_w1.m:22, diff_fftgaus_w2.m:22)."""
    f, e, U, V, w1, w2 = _gaussian_unnormalised(size, w1, w2, phi, dtype, device)
    dw1 = (w2 / (2.0 * math.pi)) * (1.0 - w1 ** 2 * U ** 2) * e
    dw2 = (w1 / (2.0 * math.pi)) * (1.0 - w2 ** 2 * V ** 2) * e
    S = _sum2(f)
    S1 = _sum2(dw1)
    S2 = _sum2(dw2)
    k = f / S
    dk1 = (dw1 * S - f * S1) / (S ** 2)
    dk2 = (dw2 * S - f * S2) / (S ** 2)
    return k, dk1, dk2


# ---------------------------------------------------------------------------
# Laplace:  k ∝ (b²/4) exp(-b(|x| + |y|))
# ---------------------------------------------------------------------------

def _laplace_abs_grid(size, dtype, device):
    v, u = psf_grid(size, dtype, device)
    return torch.abs(v) + torch.abs(u)


def laplace_kernel(size: int, b, dtype=torch.float32, device=None):
    """Normalised Laplace PSF (reference psf_laplace.m)."""
    device, (b,) = _params(dtype, device, b)
    r1 = _laplace_abs_grid(size, dtype, device)
    f = (b ** 2 / 4.0) * torch.exp(-b * r1)
    return f / _sum2(f)


def laplace_kernel_grads(size: int, b, dtype=torch.float32, device=None):
    """(kernel, dk/db): df/db = ((2b − b²(|x|+|y|))/4) exp(−b(|x|+|y|))
    (diff_laplace_b.m:10-13)."""
    device, (b,) = _params(dtype, device, b)
    r1 = _laplace_abs_grid(size, dtype, device)
    e = torch.exp(-b * r1)
    f = (b ** 2 / 4.0) * e
    db = ((2.0 * b - b ** 2 * r1) / 4.0) * e
    S = _sum2(f)
    Sd = _sum2(db)
    k = f / S
    dk = (db * S - f * Sd) / (S ** 2)
    return k, dk


# ---------------------------------------------------------------------------
# Moffat:  k ∝ (a²/2π) (1 + a² r² / b)^(-(b+2)/2)
# ---------------------------------------------------------------------------

def _moffat_r2(size, dtype, device):
    v, u = psf_grid(size, dtype, device)
    return v ** 2 + u ** 2


def moffat_kernel(size: int, a, b, dtype=torch.float32, device=None):
    """Normalised Moffat PSF (reference psf_moffat.m)."""
    device, (a, b) = _params(dtype, device, a, b)
    r2 = _moffat_r2(size, dtype, device)
    f = a ** 2 * (r2 * a ** 2 / b + 1.0) ** (-(b + 2.0) / 2.0) / (2.0 * math.pi)
    return f / _sum2(f)


def moffat_kernel_grads(size: int, a, b, dtype=torch.float32, device=None):
    """(kernel, dk/da, dk/db) of the normalised Moffat PSF.

    PARITY QUIRK kept from the reference (diff_moffat_alpha.m:17): its df/da
    carries a spurious factor 2 in the denominator of the second term, so it
    is not the exact derivative; df/db (diff_moffat_beta.m:18) is exact.
    """
    device, (a, b) = _params(dtype, device, a, b)
    r2 = _moffat_r2(size, dtype, device)
    base = r2 * a ** 2 / b + 1.0
    pw = base ** (-(b + 2.0) / 2.0)
    f = a ** 2 * pw / (2.0 * math.pi)
    da = (2.0 - ((b + 2.0) * r2 * a ** 2) / (2.0 * (b + r2 * a ** 2))) * pw * (
        a / (2.0 * math.pi)
    )
    db = (
        -torch.log(base) + ((b + 2.0) * r2 * a ** 2) / (b * (b + r2 * a ** 2))
    ) * pw * (a ** 2 / (4.0 * math.pi))
    S = _sum2(f)
    Sa = _sum2(da)
    Sb = _sum2(db)
    k = f / S
    dka = (da * S - f * Sa) / (S ** 2)
    dkb = (db * S - f * Sb) / (S ** 2)
    return k, dka, dkb
