"""NESTA — Nesterov-smoothed L1/TV minimisation with continuation (port of
`semiblind_tv_tpu/solvers/nesta.py`, SALSA/NESTA.m:105-233 and
SALSA/Core_Nesterov.m:105-407).  Solves

    min_x  ||x||_1   or  TV(x)    s.t.  ||A x - b||_2 <= delta

by Nesterov's smoothing (parameter mu) and the accelerated two-point
(yk, zk) scheme, with continuation shrinking mu geometrically from mu0 to
muf (NESTA.m:155-171):

  per inner iteration k (Core_Nesterov.m:180-283):
    df      = ∇ f_mu(xk)      (smoothed TV or L1 gradient)
    yk      = P(xk − df/Lmu)          Lmu = 1/mu (L1) or 8/mu (TV)
    wk     += 0.5 (k+1) df
    zk      = P(xplug − wk/Lmu)
    x_{k+1} = τk zk + (1 − τk) yk,    τk = 2/(k+3)
  P is the delta-ball data-constraint step (exact for AAᵀ = c·I, applied
  with the same formula for general A, as in NESTA and the reference):
    λ = max(0, Lmu(||b − A c||/δ − 1)),  γ = λ/(λ + Lmu)
    P(c) = (λ/Lmu)(1−γ) Aᵀb + c − γ AᵀA c
  stop: relative variation of f_mu against the mean of the last 10 values,
  double-triggered (Core_Nesterov.m:239-243); each continuation leg
  restarts from the previous solution.

The smoothed TV gradient Dᵀu uses the explicit adjoint of the forward
differences (`ops/tv.py::forward_gradient_adjoint`), where the JAX package
takes a vjp.  As there, the 10-entry objective buffer starts at float32's
`tiny` whatever the dtype, and each leg's iteration count is read on the
host (the leg's traces are cut to it).  Inside a leg the state freezes
once the stop fires (masked updates, no host sync per iteration); the
port reads the stop flag on the host every `_CHECK_EVERY` iterations and
leaves the leg once it is set.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.tv import forward_gradient, forward_gradient_adjoint

__all__ = ["NESTAResult", "nesta"]

_CHECK_EVERY = 32  # inner iterations between host reads of the stop flag


@dataclasses.dataclass
class NESTAResult:
    x: np.ndarray
    n_iters: int
    objective: np.ndarray   # f_mu per inner iteration (all continuation legs)
    residual: np.ndarray    # ||b - A x|| per inner iteration
    mu_final: float


def _smoothed_tv_grad(x, mu):
    """(∇f_mu, f_mu) for TV smoothing (Core_Nesterov.m Perform_TV_Constraint)."""
    dx, dy = forward_gradient(x)
    w = torch.maximum(mu, torch.sqrt(dx ** 2 + dy ** 2))
    ux, uy = dx / w, dy / w
    fx = torch.sum(ux * dx + uy * dy) - mu / 2.0 * torch.sum(torch.stack([ux, uy]) ** 2)
    return forward_gradient_adjoint(ux, uy), fx


def _smoothed_l1_grad(x, mu):
    """(∇f_mu, f_mu) for L1 smoothing (Perform_L1_Constraint, l2 prox)."""
    u = x / torch.maximum(mu, torch.abs(x))
    fx = torch.sum(u * x) - mu / 2.0 * torch.sum(u * u)
    return u, fx


def nesta(
    b,
    H,
    blur: BlurOperator,
    muf: float,
    delta: float,
    type_min: str = "tv",
    max_int_iter: int = 5,
    max_iter: int = 500,
    tol_var: float = 1e-5,
    x_plug=None,
) -> NESTAResult:
    """NESTA on blur's device and dtype; `max_int_iter` continuation legs
    of at most `max_iter` inner iterations each."""
    dtype, device = blur.dtype, blur.device
    b = torch.as_tensor(b, dtype=dtype).to(device)
    H = torch.as_tensor(H).to(device=device, dtype=blur.cdtype)
    absH2 = H.real ** 2 + H.imag ** 2
    Atb = blur.irfft(torch.conj(H) * blur.rfft_host(b))

    def A(v):
        return blur.irfft(H * blur.rfft(v))

    def AtA(v):
        return blur.irfft(absH2 * blur.rfft(v))

    grad = _smoothed_tv_grad if type_min == "tv" else _smoothed_l1_grad
    x_plug = Atb if x_plug is None else torch.as_tensor(x_plug, dtype=dtype).to(device)
    if type_min == "tv":
        dx, dy = forward_gradient(x_plug)
        mu0 = float(torch.max(torch.sqrt(dx ** 2 + dy ** 2)))
    else:
        mu0 = 0.9 * float(torch.max(torch.abs(x_plug)))
    mu0 = max(mu0, muf)
    gamma_c = (muf / mu0) ** (1.0 / max_int_iter)
    gamma_t = (tol_var / 0.1) ** (1.0 / max_int_iter)

    def project(c, Lmu):
        """The delta-ball constraint step (Core_Nesterov.m:228-234)."""
        lam = torch.clamp(Lmu * (torch.linalg.norm(b - A(c)) / delta - 1.0), min=0.0)
        g = lam / (lam + Lmu)
        return (lam / Lmu) * (1.0 - g) * Atb + c - g * AtA(c)

    def inner(xplug, mu, tolv):
        """One continuation leg: (last active iterate, iterations, f_mu and
        residual traces) — the JAX package's jitted scan."""
        Lmu = (8.0 / mu) if type_min == "tv" else (1.0 / mu)
        xk, wk, xout = xplug, torch.zeros_like(xplug), xplug
        fbuf = torch.full((10,), np.finfo(np.float32).tiny, dtype=dtype, device=device)
        fcnt = torch.ones((), dtype=dtype, device=device)
        ok = torch.zeros((), dtype=torch.bool, device=device)
        done = torch.zeros((), dtype=torch.bool, device=device)
        n_done = torch.zeros((), dtype=torch.int32, device=device)
        zero = torch.zeros((), dtype=dtype, device=device)
        rows = []
        for k in range(max_iter):
            active = torch.logical_not(done)
            df, fx = grad(xk, mu)
            resid = torch.linalg.norm(b - A(xk))
            yk = project(xk - df / Lmu, Lmu)
            wk_n = wk + 0.5 * (k + 1.0) * df
            zk = project(xplug - wk_n / Lmu, Lmu)
            tauk = 2.0 / (k + 3.0)
            xk_n = tauk * zk + (1.0 - tauk) * yk

            fmean = torch.sum(fbuf) / torch.clamp(fcnt, min=1.0)
            trigger = torch.abs(fx - fmean) / torch.abs(fmean) <= tolv
            done = done | (trigger & ok & active)
            ok = torch.where(active, ok | trigger, ok)
            fbuf = torch.where(active, torch.cat([fx[None], fbuf[:-1]]), fbuf)
            fcnt = torch.where(active, torch.clamp(fcnt + 1.0, max=10.0), fcnt)
            xout = torch.where(active, xk, xout)  # the last active iterate
            xk = torch.where(active, xk_n, xk)
            wk = torch.where(active, wk_n, wk)
            n_done = n_done + active.to(torch.int32)
            rows.append(torch.stack([torch.where(active, fx, zero),
                                     torch.where(active, resid, zero)]))
            if (k + 1) % _CHECK_EVERY == 0 and bool(done):
                break
        return xout, n_done, torch.stack(rows, dim=1) if rows else zero.new_zeros((2, 0))

    mu = mu0
    tolv = 0.1
    xplug = x_plug
    objs, resids = [], []
    total = 0
    for _ in range(max_int_iter):
        mu = mu * gamma_c
        tolv = tolv * gamma_t
        xk, n, tr = inner(xplug, torch.as_tensor(mu, dtype=dtype).to(device),
                          torch.as_tensor(tolv, dtype=dtype).to(device))
        n = int(n)
        tr = tr.cpu().numpy()
        objs.append(tr[0, :n])
        resids.append(tr[1, :n])
        total += n
        xplug = xk
    return NESTAResult(
        x=xplug.cpu().numpy(),
        n_iters=total,
        objective=np.concatenate(objs),
        residual=np.concatenate(resids),
        mu_final=float(mu),
    )
