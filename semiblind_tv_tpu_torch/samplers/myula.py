"""MYULA — Moreau–Yosida regularised Unadjusted Langevin step (port of
`semiblind_tv_tpu/samplers/myula.py`, SAPG_algorithm_Guassian.m:160-162):

    X ← |X + γ (proxG(X, θ) − X)/λ − γ ∇f(X) + sqrt(2γ) Z|,   Z ~ N(0, I)

The prox is evaluated at the previous iterate (carried across steps).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["myula_kernel_step", "myula_sampler"]


def myula_kernel_step(x, prox_cache, grad_f, gamma, lam, noise, positivity: bool = True):
    """The MYULA update given a cached prox and a precomputed gradient;
    positivity=False omits the abs() projection (SALSA/SAPG_algorithm_1.m).
    γ and λ may be 0-d device tensors."""
    gamma = torch.as_tensor(gamma, dtype=x.dtype, device=x.device)
    xn = (
        x + gamma * (prox_cache - x) / lam - gamma * grad_f + torch.sqrt(2.0 * gamma) * noise
    )
    return torch.abs(xn) if positivity else xn


def myula_sampler(
    grad_f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    generator: Optional[torch.Generator],
    n_steps: int,
    gamma,
    lam,
    theta,
    chambolle_iters: int = 25,
    noise: Optional[Callable] = None,
    prox_route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standalone fixed-hyperparameter MYULA chain (parity with SALSA/myula.m
    and the SAPG warm-up loop).  Returns (x_last, mean of the n_steps
    samples).

    noise(shape) gives each step's standard-normal field (default: normals
    from `generator` on x0's device; the tests replay the JAX draws).  The
    prox is the fresh-dual Chambolle prox of the route that
    `sapg.estimator.resolve_prox_route` picks for the image (A2 up to 512²,
    the blocked kernel above, the plain prox on the CPU); `prox_route`
    overrides it."""
    # imported here: the estimator imports this module
    from semiblind_tv_tpu_torch.sapg.estimator import FRESH_PROX, resolve_prox_route

    if noise is None:
        def noise(shape):
            return torch.randn(shape, generator=generator, dtype=x0.dtype, device=x0.device)
    route = resolve_prox_route(x0.shape[-2:], x0.device) if prox_route is None else prox_route

    def prox(x):
        return FRESH_PROX[route](x, lam * theta, chambolle_iters, return_state=False)[0]

    x, prox_cache = x0, prox(x0)
    total = torch.zeros_like(x0)
    for _ in range(n_steps):
        x = myula_kernel_step(x, prox_cache, grad_f(x), gamma, lam, noise(x.shape))
        prox_cache = prox(x)
        total += x
    return x, total / n_steps
