"""FISTA solvers for ½‖y − Ax‖² + τ·φ(x) (port of
`semiblind_tv_tpu/solvers/fista.py`).

Re-design of the reference's FISTA variants (all "modified
deblur_wavelet_FISTA_sep" ports in the reference):

  * `SALSA/my_deblur_fista.m` — TV prox (Chambolle, 10 iters), x0 = 0, L = 1
  * `SALSA/my_fista.m`        — generic prox Psi, x0 = Aᵀy, caller L

Iteration (my_fista.m:22-30):
    y_k ← y_k − (1/L) Aᵀ(A y_k − b)
    x_k ← Psi(y_k, τ/L)
    t_{k+1} = (1 + sqrt(1 + 4 t_k²))/2
    y_{k+1} = x_k + ((t_k − 1)/t_{k+1})(x_k − x_old)
stop criteria 1/2/3 like SALSA.

As in the JAX package the state freezes once the criterion fires (masked
updates, no host sync per iteration); like `salsa_tv` the port reads the
stop flag on the host every `_CHECK_EVERY` iterations and leaves the loop
once it is set, filling the remaining trace entries with the frozen
values, so the result equals running all `max_iter` iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.tv import tv_norm
from semiblind_tv_tpu_torch.sapg.estimator import FRESH_PROX, resolve_prox_route

__all__ = ["FISTAResult", "fista_tv", "fista"]

_CHECK_EVERY = 32  # iterations between host reads of the stop flag


@dataclasses.dataclass
class FISTAResult:
    x: np.ndarray
    objective: np.ndarray       # length max_iter+1 (objective[0] = initial value)
    mses: np.ndarray
    n_iters: int


def fista(
    y,
    H,
    tau,
    blur: BlurOperator,
    prox: Callable,                 # prox(v, step) -> x
    phi: Callable,                  # regulariser value for the objective
    L: float = 1.0,
    max_iter: int = 100,
    tol: float = 1e-5,
    stop_criterion: int = 1,
    x0: Optional[torch.Tensor] = None,
    x_true=None,
) -> FISTAResult:
    """Generic FISTA on blur's device and dtype; `prox(v, step)` gets the
    step τ/L as a 0-d tensor on that device."""
    if stop_criterion not in (1, 2, 3):
        raise ValueError(f"stop_criterion must be 1, 2 or 3, got {stop_criterion}")
    dtype, device = blur.dtype, blur.device
    y = torch.as_tensor(y, dtype=dtype).to(device)
    d = y.numel()
    w = blur.weights
    H = torch.as_tensor(H).to(device=device, dtype=blur.cdtype)
    tau = torch.as_tensor(tau, dtype=dtype).to(device)
    step = tau / L
    tol_t = torch.as_tensor(tol, dtype=dtype).to(device)
    yhat = blur.rfft_host(y)
    absH2 = H.real ** 2 + H.imag ** 2
    ATy_hat = torch.conj(H) * yhat

    compute_mse = x_true is not None
    if compute_mse:
        x_true = torch.as_tensor(x_true, dtype=dtype).to(device)

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return torch.sum(w * (re * re + im * im)) / d

    def grad_step(v):
        # v − (1/L) Aᵀ(A v − y), fused on the rfft grid
        vhat = blur.rfft(v)
        return blur.irfft(vhat - (absH2 * vhat - ATy_hat) / L)

    def objective_of(x):
        xhat = blur.rfft(x)
        return 0.5 * pnorm2(yhat - H * xhat) + tau * phi(x)

    if x0 is None:
        x0 = torch.zeros_like(y)  # my_deblur_fista.m:22
    x0 = torch.as_tensor(x0, dtype=dtype).to(device)
    obj0 = objective_of(x0)
    x, yk = x0, x0
    t = torch.ones((), dtype=dtype, device=device)
    prev_obj = obj0
    done = torch.zeros((), dtype=torch.bool, device=device)
    n_done = torch.zeros((), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    tr = torch.zeros((2, max_iter), dtype=dtype, device=device)  # objective, mse

    ran = 0
    for k in range(max_iter):
        active = torch.logical_not(done)
        yg = grad_step(yk)
        xn = prox(yg, step)
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        ykn = xn + ((t - 1.0) / tn) * (xn - x)

        obj = objective_of(xn)
        if stop_criterion == 1:
            crit = torch.abs(obj - prev_obj) / obj
        elif stop_criterion == 2:
            crit = torch.linalg.norm(xn - x) / torch.sqrt(torch.sum(xn * xn))
        else:
            crit = obj
        newly_done = torch.logical_and(crit < tol_t, active)

        x = torch.where(active, xn, x)
        yk = torch.where(active, ykn, yk)
        t = torch.where(active, tn, t)
        prev_obj = torch.where(active, obj, prev_obj)
        n_done = n_done + active.to(torch.int32)
        done = torch.logical_or(done, newly_done)
        mse = torch.sum((x - x_true) ** 2) / d if compute_mse else zero
        tr[:, k] = torch.stack([prev_obj, mse])
        ran = k + 1
        if ran % _CHECK_EVERY == 0 and bool(done):
            break

    traces = tr.cpu().numpy()
    if ran < max_iter:
        traces[:, ran:] = traces[:, ran - 1:ran]  # the frozen tail
    mses = traces[1]
    if compute_mse:
        mses = np.concatenate([[float(torch.sum((x0 - x_true) ** 2) / d)], mses])
    return FISTAResult(
        x=x.cpu().numpy(),
        objective=np.concatenate([[float(obj0)], traces[0]]),
        mses=mses,
        n_iters=int(n_done),
    )


def fista_tv(
    y,
    H,
    tau,
    blur: BlurOperator,
    tv_iters: int = 10,
    L: float = 1.0,
    max_iter: int = 100,
    tol: float = 1e-5,
    stop_criterion: int = 1,
    x_true=None,
    prox_route: Optional[str] = None,
) -> FISTAResult:
    """TV-FISTA (my_deblur_fista.m): Chambolle prox, x0 = 0, L = 1.

    Each iteration runs one fresh-dual `tv_iters`-sweep prox (tol 1e-3),
    through the kernel that `sapg.estimator.resolve_prox_route` picks for
    the image: kernel A2 (`chambolle_prox_cuda(return_state=False)`) up to
    512², the blocked kernel (`chambolle_prox_blocked`, rows F/H) above,
    the plain prox on the CPU; `prox_route` ('plain', 'A2', 'F', 'H')
    overrides it.  The JAX fista_tv defaults to the XLA prox; A2 computes
    the same function and is bit-equal to the plain prox at a fixed sweep
    count, but it sums the early-exit residual in another order, so a
    residual on the edge of tol can stop on another sweep (the known
    "early-exit reduction order" class of divergence)."""
    if prox_route is None:
        prox_route = resolve_prox_route(blur.shape, blur.device)
    prox_fn = FRESH_PROX[prox_route]

    def prox(v, step):
        f, _ = prox_fn(v, step, tv_iters, return_state=False)
        return f

    return fista(
        y, H, tau, blur, prox, tv_norm, L=L, max_iter=max_iter, tol=tol,
        stop_criterion=stop_criterion, x_true=x_true,
    )
