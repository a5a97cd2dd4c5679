"""Total variation and the Chambolle TV prox, plainly.

utils/TVnorm.m: isotropic TV with circular backward differences.
utils/chambolle_prox_TV_stop.m:120-166: dual ascent
p ← (p + τ∇u)/(1 + τ|∇u|) with u = div p − g/λ, the Neumann divergence of
lines 152-159 (its last row is −p1[M−1], as the MATLAB code has it), the
forward gradient with a zero last row and column, and a stop once the
fixed-point residual ‖|∇u|·p − ∇u‖ computed before a sweep's update is at
most tol (that sweep's update is still applied).  Each chain of a (B, M, N)
batch stops on its own residual.  The two dual fields are kept stacked,
p = (p1, p2), so that a sweep is a few whole-array operations.
"""
from __future__ import annotations

import torch

from portbench.reference.precision import exact


def tv_norm(x):
    dh = x - torch.roll(x, 1, dims=-1)
    dv = x - torch.roll(x, 1, dims=-2)
    return torch.sum(torch.sqrt(dh * dh + dv * dv), dim=(-2, -1))


def divergence(p):
    p1, p2 = p[0], p[1]
    u = torch.empty_like(p1)
    u[..., 0, :] = p1[..., 0, :]
    torch.sub(p1[..., 1:-1, :], p1[..., :-2, :], out=u[..., 1:-1, :])
    torch.neg(p1[..., -1, :], out=u[..., -1, :])
    u[..., :, 0] += p2[..., :, 0]
    u[..., :, 1:-1] += p2[..., :, 1:-1] - p2[..., :, :-2]
    u[..., :, -1] -= p2[..., :, -1]
    return u


def chambolle(g, lam, sweeps, tau, tol, p=None, q=exact):
    """prox_{λ TV}(g) for a (B, M, N) batch; lam is one value or (B, 1, 1),
    p the (2, B, M, N) duals to start from (zeros if None).  Returns
    (f, the duals, the sweeps each chain ran)."""
    B = g.shape[0]
    p = torch.zeros((2,) + tuple(g.shape), dtype=g.dtype, device=g.device) if p is None else p
    glam = q(g / lam)
    grad = torch.zeros_like(p)
    active = torch.ones((1, B, 1, 1), dtype=torch.bool, device=g.device)
    done = torch.zeros((B,), dtype=torch.int32, device=g.device)
    for _ in range(sweeps):
        u = q(divergence(p) - glam)
        torch.sub(u[..., 1:, :], u[..., :-1, :], out=grad[0, ..., :-1, :])
        torch.sub(u[..., :, 1:], u[..., :, :-1], out=grad[1, ..., :, :-1])
        grad = q(grad)
        mag = q(torch.linalg.vector_norm(grad, dim=0))
        resid = torch.linalg.vector_norm(mag * p - grad, dim=(0, -2, -1))
        new = q((p + tau * grad) / q(1.0 + tau * mag))
        p = torch.where(active, new, p)
        done += active.view(B).to(torch.int32)
        active = torch.logical_and(active, (resid > tol).view(1, B, 1, 1))
    return q(g - lam * divergence(p)), p, done
