"""SALSA for min_x ½‖y − Ax‖² + τ·TV(x) (SALSA_v2.m:379-440), plainly.

From x = b = 0 and zero duals, each outer iteration:

    u  = prox_{(τ/µ)·TV}(x − b)    tv_iters Chambolle sweeps, duals kept
                                   from the last iteration (line 429)
    x' = irfft2((conj(H)·ŷ + µ·rfft2(u + b)) / (|H|² + µ))
    b' = b + u − x'

The stop criterion is not evaluated: the benchmark's solves run a fixed
number of outer iterations (tol 0).
"""
from __future__ import annotations

import torch

from portbench.reference.precision import exact
from portbench.reference.tv import chambolle


def solve(y, H, tau, mu, iters, tv_iters, chambolle_tau, chambolle_tol, q=exact):
    """(x after `iters` outer iterations, mean sweeps a prox call)."""
    shape = y.shape
    ATy = q(torch.conj(H) * torch.fft.rfft2(y))
    inv = q(1.0 / (H.real ** 2 + H.imag ** 2 + mu))
    x = torch.zeros_like(y)[None]
    b = torch.zeros_like(x)
    p = None
    sweeps = []
    for _ in range(iters):
        u, p, n = chambolle(x - b, tau / mu, tv_iters, chambolle_tau, chambolle_tol, p=p, q=q)
        sweeps.append(n.sum())
        xhat = q(inv * (ATy + mu * q(torch.fft.rfft2(u + b))))
        xn = q(torch.fft.irfft2(xhat, s=shape))
        b = q(b + (u - xn))
        x = xn
    return x[0], float(torch.stack(sweeps).double().mean())
