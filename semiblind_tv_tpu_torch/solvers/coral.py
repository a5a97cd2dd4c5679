"""CoRAL — ADMM with two compound regularisers (port of
`semiblind_tv_tpu/solvers/coral.py`, SALSA/CoRAL_v2.m:394-470):

    min_x ½‖y − Ax‖² + τ1·φ1(x) + τ2·φ2(x)

Per outer iteration, on the rfft-diagonal blur operator:

    u ← prox_{τ1/µ1 · φ1}(x − bu)         (TV by Chambolle, or L1 soft)
    v ← prox_{τ2/µ2 · φ2}(x − bv)
    x ← (AᵀA + (µ1+µ2) I)⁻¹ (Aᵀy + µ1(u+bu) + µ2(v+bv))
    bu ← bu + u − x;   bv ← bv + v − x
    stop criteria 1/2/3 as in SALSA (CoRAL_v2.m:435-455), from the second
    iteration on.

`coral_tv_l1`'s cold TV prox (the reference default) takes the fresh-dual
route of `sapg/estimator.py::resolve_prox_route` (kernel A2 up to 512², the
blocked kernel above, the plain prox on the CPU), as `fista_tv` does; its
warm variant (`tv_warm_start=True`, the TVINITIALIZATION leg) carries the
duals across iterations through the warm route of
`solvers/salsa.py::resolve_salsa_prox_mode` (kernel A1 up to 512²).
`prox_route` overrides either.

As in the JAX package the state freezes once the stop fires (masked
updates, no host sync per iteration); the port reads the stop flag on the
host every `_CHECK_EVERY` iterations and leaves the loop once it is set,
filling the rest of the traces with the frozen values, so the result
equals running all `max_iter` iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.tv import tv_norm
from semiblind_tv_tpu_torch.sapg.estimator import FRESH_PROX, resolve_prox_route
from semiblind_tv_tpu_torch.solvers.salsa import (
    SALSA_PROX,
    l1_norm,
    resolve_salsa_prox_mode,
    soft_threshold,
)

__all__ = ["CoRALResult", "coral_tv_l1", "coral"]

_CHECK_EVERY = 32  # outer iterations between host reads of the stop flag


@dataclasses.dataclass
class CoRALResult:
    x: np.ndarray
    objective: np.ndarray   # length max_iter+1 (objective[0] = ½‖y‖²)
    mses: np.ndarray
    n_iters: int


def coral(
    y,
    H,
    tau1: float,
    tau2: float,
    blur: BlurOperator,
    prox1: Callable,
    phi1: Callable,
    prox2: Callable,
    phi2: Callable,
    mu1: float = 1e-3,
    mu2: float = 1e-3,
    max_iter: int = 200,
    tol: float = 1e-4,
    stop_criterion: int = 1,
    x_true=None,
) -> CoRALResult:
    """Generic two-regulariser ADMM on blur's device and dtype.
    prox_i(v, thresh) -> x gets its threshold τi/µi as a 0-d tensor on that
    device."""
    return _coral(y, H, tau1, tau2, blur, prox1, phi1, prox2, phi2, mu1, mu2, max_iter, tol,
                  stop_criterion, x_true, warm_duals=False)


def _coral(y, H, tau1, tau2, blur, prox1, phi1, prox2, phi2, mu1, mu2, max_iter, tol,
           stop_criterion, x_true, warm_duals):
    """The ADMM loop; with warm_duals, prox1(v, thresh, duals) -> (f, state)
    and the duals are carried across iterations."""
    dtype, device = blur.dtype, blur.device
    y = torch.as_tensor(y, dtype=dtype).to(device)
    d = y.numel()
    w = blur.weights
    H = torch.as_tensor(H).to(device=device, dtype=blur.cdtype)
    yhat = blur.rfft_host(y)
    ATy_hat = torch.conj(H) * yhat
    inv_filter = 1.0 / (H.real ** 2 + H.imag ** 2 + (mu1 + mu2))
    th1 = torch.as_tensor(tau1 / mu1, dtype=dtype).to(device)
    th2 = torch.as_tensor(tau2 / mu2, dtype=dtype).to(device)
    compute_mse = x_true is not None
    if compute_mse:
        x_true = torch.as_tensor(x_true, dtype=dtype).to(device)

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return torch.sum(w * (re * re + im * im)) / d

    z = torch.zeros_like(y)
    x, bu, bv, pux, puy = z, z, z, z, z
    obj0 = 0.5 * torch.sum(y * y)
    prev_obj = obj0
    done = torch.zeros((), dtype=torch.bool, device=device)
    n_done = torch.zeros((), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    rows = []
    for k in range(max_iter):
        active = torch.logical_not(done)
        if warm_duals:
            un, st = prox1(x - bu, th1, (pux, puy))
            pux = torch.where(active, st.px, pux)
            puy = torch.where(active, st.py, puy)
        else:
            un = prox1(x - bu, th1)
        vn = prox2(x - bv, th2)
        xhat = inv_filter * (ATy_hat + blur.rfft(mu1 * (un + bu) + mu2 * (vn + bv)))
        xn = blur.irfft(xhat)
        bun = bu + (un - xn)
        bvn = bv + (vn - xn)
        obj = 0.5 * pnorm2(yhat - H * xhat) + tau1 * phi1(un) + tau2 * phi2(vn)
        if stop_criterion == 1:
            crit = torch.abs(obj - prev_obj) / prev_obj
        elif stop_criterion == 2:
            crit = torch.linalg.norm(xn - x) / torch.linalg.norm(xn)
        else:
            crit = obj
        if k >= 1:
            done = done | ((crit < tol) & active)

        x = torch.where(active, xn, x)
        bu = torch.where(active, bun, bu)
        bv = torch.where(active, bvn, bv)
        prev_obj = torch.where(active, obj, prev_obj)
        n_done = n_done + active.to(torch.int32)
        mse = torch.sum((x - x_true) ** 2) / d if compute_mse else zero
        rows.append(torch.stack([prev_obj, mse]))
        if (k + 1) % _CHECK_EVERY == 0 and bool(done):
            break

    tr = np.zeros((2, max_iter))
    if rows:
        tr[:, :len(rows)] = torch.stack(rows, dim=1).cpu().numpy()
        tr[:, len(rows):] = tr[:, len(rows) - 1:len(rows)]   # the frozen tail
    return CoRALResult(
        x=x.cpu().numpy(),
        objective=np.concatenate([[float(obj0)], tr[0]]),
        mses=tr[1],
        n_iters=int(n_done),
    )


def coral_tv_l1(
    y, H, tau_tv, tau_l1, blur, mu1=1e-3, mu2=1e-3, tv_iters=10,
    max_iter=200, tol=1e-4, x_true=None, tv_warm_start=False,
    prox_route: Optional[str] = None, chambolle_tol: float = 1e-3,
):
    """TV + L1 compound regularisation (the canonical CoRAL configuration),
    stop criterion 1.

    tv_warm_start=False (the reference default): a cold `tv_iters`-sweep
    prox an iteration on resolve_prox_route's fresh route ('plain', 'A2',
    'F', 'H'); True carries the Chambolle duals across outer iterations
    (CoRAL_v2.m:401-403) on resolve_salsa_prox_mode's warm route ('plain',
    'A1', 'F', 'H').  prox_route overrides the route; chambolle_tol is the
    prox's early-exit tolerance."""
    if not tv_warm_start:
        fresh = FRESH_PROX[prox_route or resolve_prox_route(blur.shape, blur.device)]

        def prox_tv(v, t):
            return fresh(v, t, tv_iters, tol=chambolle_tol, return_state=False)[0]
    else:
        warm = SALSA_PROX[prox_route or resolve_salsa_prox_mode(blur.shape, blur.device)]

        def prox_tv(v, t, duals):
            return warm(v, t, tv_iters, tol=chambolle_tol, duals=duals)

    return _coral(y, H, tau_tv, tau_l1, blur, prox_tv, tv_norm, soft_threshold, l1_norm, mu1,
                  mu2, max_iter, tol, 1, x_true, warm_duals=tv_warm_start)
