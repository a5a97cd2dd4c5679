"""MYULA — Moreau–Yosida regularised Unadjusted Langevin step (port of
`semiblind_tv_tpu/samplers/myula.py`, SAPG_algorithm_Guassian.m:160-162):

    X ← |X + γ (proxG(X, θ) − X)/λ − γ ∇f(X) + sqrt(2γ) Z|,   Z ~ N(0, I)

The prox is evaluated at the previous iterate (carried across steps).
"""
from __future__ import annotations

import torch

__all__ = ["myula_kernel_step"]


def myula_kernel_step(x, prox_cache, grad_f, gamma, lam, noise, positivity: bool = True):
    """The MYULA update given a cached prox and a precomputed gradient;
    positivity=False omits the abs() projection (SALSA/SAPG_algorithm_1.m).
    γ and λ may be 0-d device tensors."""
    gamma = torch.as_tensor(gamma, dtype=x.dtype, device=x.device)
    xn = (
        x + gamma * (prox_cache - x) / lam - gamma * grad_f + torch.sqrt(2.0 * gamma) * noise
    )
    return torch.abs(xn) if positivity else xn
