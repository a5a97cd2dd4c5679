"""Total-variation norm and the Chambolle dual-projection TV prox (port of
`semiblind_tv_tpu/ops/tv.py`).

  * `tv_norm` — utils/TVnorm.m with circular backward differences.
  * `chambolle_prox` — utils/chambolle_prox_TV_stop.m:120-166: dual ascent
    p ← (p + τ∇u)/(1 + τ|∇u|), Neumann divergence/gradient stencils, early
    exit once the pre-update fixed-point residual is ≤ tol, optional warm
    duals, f = g − λ div p.

The deliberate boundary discrepancy of the reference is kept (circular TV
norm, Neumann prox), and so is `divergence`'s last row −p1[M−1] (not the
textbook −p1[M−2]).

All functions act on the last two dimensions, so a chain batch (B, M, N)
goes through in one call.  The early exit is a masked fixed-trip loop
(`torch.where` on a per-chain `active` flag): no host synchronisation, and
the result equals breaking out of the loop.  This is the plain version that
the CUDA kernels (ops/tv_cuda.py, ops/fused_step_cuda.py) are held against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["tv_norm", "divergence", "forward_gradient", "chambolle_prox", "ChambolleState"]


def tv_norm(x: torch.Tensor) -> torch.Tensor:
    """Isotropic TV with circular backward differences (utils/TVnorm.m),
    summed over the last two dims (a (B,) vector for a chain batch)."""
    dh = x - torch.roll(x, 1, dims=-1)
    dv = x - torch.roll(x, 1, dims=-2)
    return torch.sum(torch.sqrt(dh * dh + dv * dv), dim=(-2, -1))


def divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Neumann-boundary divergence (chambolle_prox_TV_stop.m:152-159):
      u[0] = p1[0];  u[i] = p1[i] - p1[i-1] (1 <= i <= M-2);  u[M-1] = -p1[M-1]
    and symmetrically for the columns with p2."""
    u = torch.cat(
        [p1[..., :1, :], p1[..., 1:-1, :] - p1[..., :-2, :], -p1[..., -1:, :]], dim=-2
    )
    v = torch.cat(
        [p2[..., :, :1], p2[..., :, 1:-1] - p2[..., :, :-2], -p2[..., :, -1:]], dim=-1
    )
    return u + v


def forward_gradient(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences with zero last row/column (chambolle_prox_TV_stop.m:161-166)."""
    dux = torch.cat([u[..., 1:, :] - u[..., :-1, :], torch.zeros_like(u[..., :1, :])], dim=-2)
    duy = torch.cat([u[..., :, 1:] - u[..., :, :-1], torch.zeros_like(u[..., :, :1])], dim=-1)
    return dux, duy


class ChambolleState(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    iters: torch.Tensor  # dual-ascent sweeps actually applied (int32, per chain)
    err: torch.Tensor    # last fixed-point residual (per chain)


def chambolle_prox(
    g: torch.Tensor,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ChambolleState]:
    """prox_{λ TV}(g) = argmin_x ½||g − x||² + λ TV(x) by Chambolle dual ascent.

    g is (M, N) or a chain batch (B, M, N); each chain stops on its own
    residual.  Returns (f, state); state carries the duals for warm starts
    (the reference's 'dualvars' option, SALSA_v2.m:429)."""
    squeeze = g.ndim == 2
    if squeeze:
        g = g[None]
        if duals is not None:
            duals = (duals[0][None], duals[1][None])
    if duals is None:
        px = torch.zeros_like(g)
        py = torch.zeros_like(g)
    else:
        px, py = duals

    B = g.shape[0]
    glam = g / lam
    k = torch.zeros((B,), dtype=torch.int32, device=g.device)
    err = torch.full((B,), float("inf"), dtype=g.dtype, device=g.device)
    active = torch.ones((B,), dtype=torch.bool, device=g.device)
    for _ in range(max_iter):
        divp = divergence(px, py)
        u = divp - glam
        upx, upy = forward_gradient(u)
        tmp = torch.sqrt(upx * upx + upy * upy)
        rx = -upx + tmp * px
        ry = -upy + tmp * py
        step_err = torch.sqrt(torch.sum(rx * rx + ry * ry, dim=(-2, -1)))
        denom = 1.0 + tau * tmp
        new_px = (px + tau * upx) / denom
        new_py = (py + tau * upy) / denom
        a3 = active[:, None, None]
        px = torch.where(a3, new_px, px)
        py = torch.where(a3, new_py, py)
        err = torch.where(active, step_err, err)
        k = k + active.to(torch.int32)
        active = torch.logical_and(active, step_err > tol)
    f = g - lam * divergence(px, py)
    if squeeze:
        return f[0], ChambolleState(px=px[0], py=py[0], iters=k[0], err=err[0])
    return f, ChambolleState(px=px, py=py, iters=k, err=err)
