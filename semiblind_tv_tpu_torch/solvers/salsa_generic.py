"""Generic-operator SALSA: the reference's full call signature (port of
`semiblind_tv_tpu/solvers/salsa_generic.py`).

`solvers/salsa.py::salsa_tv` is the rfft-diagonal fast path of the demos.
`SALSA_v2.m` takes any linear A with caller-provided Aᵀ and LS inverse, and
any Ψ/Φ pair with an optional P/Pᵀ analysis transform (SALSA_v2.m:156-252):

    x = salsa(y, A=..., AT=..., inv_ls=..., prox=..., phi=..., mu=..., tau=...)

The callables take and return tensors on y's device; `prox` gets its
threshold τ/µ as a 0-d tensor there.  As in the JAX package the state
freezes once the criterion fires (masked updates, no host sync per
iteration); the port reads the stop flag on the host every `_CHECK_EVERY`
iterations and leaves the loop once it is set, filling the rest of the
objective trace with the frozen value, so the result equals running all
`max_iter` iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from semiblind_tv_tpu_torch.solvers.salsa import l1_norm, soft_threshold

__all__ = ["GenericSALSAResult", "salsa", "salsa_v1"]

_CHECK_EVERY = 32  # iterations between host reads of the stop flag


def _identity(v):
    return v


@dataclasses.dataclass
class GenericSALSAResult:
    x: np.ndarray
    objective: np.ndarray   # length max_iter+1 (objective[0] = initial value)
    n_iters: int


def _threshold(value: float, y: torch.Tensor) -> torch.Tensor:
    """τ/µ as a 0-d real tensor on y's device (made once: a Python number
    would be copied to the device at every prox call)."""
    return torch.tensor(value, dtype=y.real.dtype if y.is_complex() else y.dtype,
                        device=y.device)


def _crit(stop_criterion, obj, prev_obj, xn, x):
    """The stop criterion of SALSA_v2.m:455-469 / SALSA.m:514-530."""
    if stop_criterion == 1:
        return torch.abs(obj - prev_obj) / prev_obj
    if stop_criterion == 2:
        return torch.linalg.norm(xn - x) / torch.linalg.norm(xn)
    return obj


def _result(x, obj0, objs, ran, max_iter, n_done):
    objs = torch.stack(objs).cpu().numpy() if objs else np.zeros((0,))
    objective = np.concatenate([[float(obj0)], objs,
                                np.full(max_iter - ran, objs[-1] if ran else float(obj0))])
    return GenericSALSAResult(x=x.cpu().numpy(), objective=objective, n_iters=int(n_done))


def salsa(
    y,
    A: Callable,
    AT: Callable,
    inv_ls: Callable,               # r -> (AᵀA + µI)⁻¹ r (the 'LS' handle)
    tau: float,
    mu: float,
    prox: Optional[Callable] = None,   # (v, thresh) -> u; default soft (SALSA_v2.m:337)
    phi: Optional[Callable] = None,    # regulariser value; default L1
    P: Optional[Callable] = None,      # synthesis (default identity)
    PT: Optional[Callable] = None,     # analysis  (default identity)
    max_iter: int = 500,
    tol: float = 1e-5,
    stop_criterion: int = 1,
    x0=None,
) -> GenericSALSAResult:
    """SALSA v2 with caller operators, on y's device; the stop is tested
    from the second iteration on (SALSA_v2.m:453)."""
    prox = prox if prox is not None else soft_threshold
    phi = phi if phi is not None else l1_norm
    P = P if P is not None else _identity
    PT = PT if PT is not None else _identity

    y = torch.as_tensor(y)
    ATy = AT(y)
    thresh = _threshold(tau / mu, y)
    x = torch.zeros_like(ATy) if x0 is None else torch.as_tensor(x0).to(ATy)
    u0 = PT(x)
    resid0 = y - A(x)
    obj0 = 0.5 * torch.sum(resid0 * resid0) + tau * phi(u0)
    bu = torch.zeros_like(u0)
    prev_obj = obj0
    done = torch.zeros((), dtype=torch.bool, device=y.device)
    n_done = torch.zeros((), dtype=torch.int32, device=y.device)
    objs = []
    for k in range(max_iter):
        active = torch.logical_not(done)
        un = prox(PT(x) - bu, thresh)
        xn = inv_ls(ATy + mu * P(un + bu))
        bun = bu + (un - PT(xn))
        resid = y - A(xn)
        obj = 0.5 * torch.sum(resid * resid) + tau * phi(un)
        crit = _crit(stop_criterion, obj, prev_obj, xn, x)
        if k >= 1:
            done = torch.logical_or(done, torch.logical_and(crit < tol, active))
        x = torch.where(active, xn, x)
        bu = torch.where(active, bun, bu)
        prev_obj = torch.where(active, obj, prev_obj)
        n_done = n_done + active.to(torch.int32)
        objs.append(prev_obj)
        if (k + 1) % _CHECK_EVERY == 0 and bool(done):
            break
    return _result(x, obj0, objs, len(objs), max_iter, n_done)


def salsa_v1(
    y,
    A: Callable,
    AT: Callable,
    inv_ls: Callable,
    tau: float,
    mu: float,
    prox: Optional[Callable] = None,
    phi: Optional[Callable] = None,
    inner_iters: int = 1,
    max_iter: int = 500,
    tol: float = 1e-4,
    stop_criterion: int = 1,
    x0=None,
    output: str = "x",               # 'x' or 'z' (SALSA.m outputvar, :558-562)
) -> GenericSALSAResult:
    """SALSA v1: Bregman outer loop with `inner_iters` (prox, LS) passes per
    dual update (SALSA/SALSA.m:476-502).  Per outer iteration, inner_iters
    times: z ← prox(x − b, τ/µ); x ← (AᵀA+µI)⁻¹(Aᵀy + µ(z+b)); then
    b ← b + (z − x), objective ½‖y−Ax‖² + τφ(x) (SALSA.m:505); stop
    criteria 1/2/3 as in SALSA.m:514-530."""
    prox = prox if prox is not None else soft_threshold
    phi = phi if phi is not None else l1_norm
    y = torch.as_tensor(y)
    ATy = AT(y)
    thresh = _threshold(tau / mu, y)
    x = torch.zeros_like(ATy) if x0 is None else torch.as_tensor(x0).to(ATy)
    resid0 = y - A(x)
    obj0 = 0.5 * torch.sum(resid0 * resid0) + tau * phi(x)
    z = torch.zeros_like(x)
    b = torch.zeros_like(x)
    prev_obj = obj0
    done = torch.zeros((), dtype=torch.bool, device=y.device)
    n_done = torch.zeros((), dtype=torch.int32, device=y.device)
    objs = []
    for k in range(max_iter):
        active = torch.logical_not(done)
        xn, zn = x, z
        for _ in range(inner_iters):
            zn = prox(xn - b, thresh)
            xn = inv_ls(ATy + mu * (zn + b))
        bn = b + (zn - xn)
        resid = y - A(xn)
        obj = 0.5 * torch.sum(resid * resid) + tau * phi(xn)
        crit = _crit(stop_criterion, obj, prev_obj, xn, x)
        if k >= 1:
            done = torch.logical_or(done, torch.logical_and(crit < tol, active))
        x = torch.where(active, xn, x)
        z = torch.where(active, zn, z)
        b = torch.where(active, bn, b)
        prev_obj = torch.where(active, obj, prev_obj)
        n_done = n_done + active.to(torch.int32)
        objs.append(prev_obj)
        if (k + 1) % _CHECK_EVERY == 0 and bool(done):
            break
    return _result(z if output == "z" else x, obj0, objs, len(objs), max_iter, n_done)
