"""C-SALSA — constrained SALSA:  min φ(Pᵀx)  s.t.  ‖Ax − y‖₂ ≤ ε  (port of
`semiblind_tv_tpu/solvers/csalsa.py`, SALSA/CSALSA_v2.m:160-561).

Per outer iteration (CSALSA_v2.m:462-518):

    r   = µ1 P(u + bu) + µ2 Aᵀ(y + v + bv)
    x   = (µ2 AᵀA + µ1 I)⁻¹ r               caller LS solve ('LS' handle)
    u   = Ψ(Pᵀx − bu, 1/µ1)                 denoiser (TV: warm-started duals)
    ve  = Ax − y − bv;  v = ve·min(1, ε/‖ve‖)   (ε-ball projection, :483-489)
    bv ← bv − (Ax − y − v);  bu ← bu − (Pᵀx − u)
    µ1 ← δ·µ1, µ2 ← δ·µ2                    (continuation, :517-518)
    stop: rel-Δ criterion < tol  AND  ‖Ax − y‖ ≤ ε      (:520-545)

Default ε = sqrt(d + 8√d)·σ (CSALSA_v2.m:412-413).

Three surfaces, as in the JAX package:
  * `csalsa`       — the generic option surface (caller A/Aᵀ/LS, Ψ/Φ pair,
                     P/Pᵀ pair, TV initialisation, four stop criteria,
                     continuation); its stop is tested from the first pass.
  * `csalsa_tv`    — the TV specialisation fused on the rfft half-spectrum
                     grid; its stop is tested from the second pass
                     (k ≥ 1), the JAX package's own difference.
  * `csalsa_synthesis` — the older csalsa.m frame-synthesis prior with the
                     Woodbury LS solve for Parseval frames.

The TV prox of `csalsa_tv` and `csalsa(tv_init=True)` is the warm-dual
prox that `solvers/salsa.py::resolve_salsa_prox_mode` picks on the device
(kernel A1 up to 512², the blocked kernel above, the plain prox on the
CPU); `prox_route` overrides it where the JAX package has `use_pallas`.
The objective is φ(x), not φ(Pᵀx), as in the reference (CSALSA_v2.m:499).

As in the JAX package the state freezes once the stop fires (masked
updates, no host sync per iteration); the port reads the stop flag on the
host every `_CHECK_EVERY` iterations and leaves the loop once it is set,
filling the rest of the traces with the frozen values (the distances with
0), so the result equals running all `max_iter` iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.tv import tv_norm
from semiblind_tv_tpu_torch.solvers.salsa import (
    SALSA_PROX,
    l1_norm,
    resolve_salsa_prox_mode,
    soft_threshold,
)

__all__ = ["CSALSAResult", "csalsa", "csalsa_tv", "csalsa_synthesis"]

_CHECK_EVERY = 32  # outer iterations between host reads of the stop flag


@dataclasses.dataclass
class CSALSAResult:
    x: np.ndarray
    objective: np.ndarray      # φ(x) per iteration
    criterion: np.ndarray      # ‖Ax − y‖ per iteration
    mses: np.ndarray
    n_iters: int
    distance1: Optional[np.ndarray] = None  # ‖Ax − y − v‖ (CSALSA_v2.m:496)
    distance2: Optional[np.ndarray] = None  # ‖Pᵀx − u‖   (CSALSA_v2.m:498)


def default_epsilon(d: int, sigma) -> float:
    """ε = sqrt(d + 8√d)·σ (CSALSA_v2.m:412-413)."""
    if sigma is None:
        raise ValueError("provide epsilon or sigma")
    return float(np.sqrt(d + 8.0 * np.sqrt(d)) * float(sigma))


def _traces(rows, n_rows, max_iter, frozen):
    """(n_rows, max_iter) host array of the per-iteration tuples in `rows`;
    the rows in `frozen` hold their last value over the tail the loop
    skipped, the others are 0 there."""
    out = np.zeros((n_rows, max_iter))
    ran = len(rows)
    if ran:
        out[:, :ran] = torch.stack([torch.stack(r) for r in rows], dim=1).cpu().numpy()
        for i in frozen:
            out[i, ran:] = out[i, ran - 1]
    return out


def csalsa(
    y,
    A: Callable,
    AT: Callable,
    invLS: Callable,
    mu1: float,
    mu2: float,
    *,
    sigma: Optional[float] = None,
    epsilon: Optional[float] = None,
    prox: Optional[Callable] = None,
    phi: Optional[Callable] = None,
    P: Optional[Callable] = None,
    PT: Optional[Callable] = None,
    tv_init: bool = False,
    tv_iters: int = 5,
    delta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-3,
    stop_criterion: int = 3,
    x0=None,
    x_true=None,
    prox_route: Optional[str] = None,
    chambolle_tol: float = 1e-3,
) -> CSALSAResult:
    """Generic C-SALSA with the reference's option surface
    (CSALSA_v2.m:88-137 options, :462-518 loop, :520-545 stopping), on y's
    device.

      A/AT           forward operator pair (:273-296).
      invLS          LS solve applying (µ1 I + µ2 AᵀA)⁻¹ for tight P
                     (PPᵀ = I); called as invLS(r, mu1, mu2) with 0-d
                     tensors each iteration so continuation reaches it.
      prox           Ψ(v, tau) denoiser ('Psi'); default soft threshold.
      phi            Φ objective; default ‖·‖₁, or TVnorm under tv_init;
                     evaluated at x, not Pᵀx (the reference's quirk).
      P/PT           analysis pair (default identity); u/bu live in
                     Pᵀ-space.
      tv_init        'TVINITIALIZATION': the warm-dual Chambolle TV prox
                     (tv_iters sweeps, tol chambolle_tol) replaces Ψ; its
                     route is resolve_salsa_prox_mode's unless prox_route
                     ('plain', 'A1', 'F', 'H') is given.
      stop_criterion 1 rel-Δ objective, 2 rel-Δ x, 3 rel-Δ criterion,
                     4 minimum iteration count (tol = the count); all AND
                     ‖Ax−y‖ ≤ ε.
      x0             None → zeros; "aty" → Aᵀy; or an explicit array."""
    if stop_criterion not in (1, 2, 3, 4):
        raise ValueError(f"unknown stop criterion {stop_criterion}")
    y = torch.as_tensor(y)
    device = y.device
    if epsilon is None:
        epsilon = default_epsilon(y.numel(), sigma)
    if P is None:
        P = PT = _identity
    elif PT is None:
        raise ValueError("If you give P you must also give PT, and vice versa")
    if prox is None:
        prox = soft_threshold
    if phi is None:
        phi = tv_norm if tv_init else l1_norm
    if tv_init:
        tv_prox = SALSA_PROX[prox_route or resolve_salsa_prox_mode(y.shape[-2:], device)]

    aty = AT(y)
    dtype = aty.dtype
    if x0 is None:
        x = torch.zeros_like(aty)
    elif isinstance(x0, str) and x0 == "aty":
        x = aty
    else:
        x = torch.as_tensor(x0).to(aty)
    compute_mse = x_true is not None
    if compute_mse:
        x_true = torch.as_tensor(x_true).to(aty)

    u = torch.zeros_like(PT(x))
    bu, pux, puy = u, u, u
    v = torch.zeros_like(y)
    bv = v
    eps = torch.as_tensor(epsilon, dtype=dtype).to(device)
    m1 = torch.as_tensor(mu1, dtype=dtype).to(device)
    m2 = torch.as_tensor(mu2, dtype=dtype).to(device)
    prev_obj = phi(x)
    prev_crit = torch.linalg.norm(A(x) - y)
    done = torch.zeros((), dtype=torch.bool, device=device)
    n_done = torch.zeros((), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    rows = []
    for k in range(max_iter):
        active = torch.logical_not(done)
        xn = invLS(m1 * P(u + bu) + m2 * AT(y + v + bv), m1, m2)
        ptx = PT(xn)
        if tv_init:
            g = ptx - bu
            un, st = tv_prox(g.real if g.is_complex() else g, 1.0 / m1, tv_iters,
                             tol=chambolle_tol, duals=(pux, puy))
            pux_n, puy_n = st.px, st.py
        else:
            un = prox(ptx - bu, 1.0 / m1)
            pux_n, puy_n = pux, puy

        Ax = A(xn)
        ve = Ax - y - bv
        n_ve = torch.linalg.norm(ve)
        vn = torch.where(n_ve <= eps, ve, ve / n_ve * eps)
        bvn = bv - (Ax - y - vn)
        bun = bu - (ptx - un)

        crit = torch.linalg.norm(Ax - y)
        dist1 = torch.linalg.norm(Ax - y - vn)
        dist2 = torch.linalg.norm(ptx - un)
        obj = phi(xn)
        if stop_criterion == 1:
            sc_ok = torch.abs(obj - prev_obj) / obj < tol
        elif stop_criterion == 2:
            sc_ok = torch.linalg.norm(xn - x) / torch.linalg.norm(xn) < tol
        elif stop_criterion == 3:
            sc_ok = torch.abs(crit - prev_crit) / crit < tol
        else:
            # the minimum iteration count (:543-545), known on the host
            sc_ok = torch.ones_like(active) if k + 2 >= tol else torch.zeros_like(active)
        # the reference checks from its first loop pass (CSALSA_v2.m:520-545)
        newly = sc_ok & (crit <= eps) & active

        x = torch.where(active, xn, x)
        u = torch.where(active, un, u)
        bu = torch.where(active, bun, bu)
        v = torch.where(active, vn, v)
        bv = torch.where(active, bvn, bv)
        pux = torch.where(active, pux_n, pux)
        puy = torch.where(active, puy_n, puy)
        m1 = torch.where(active, m1 * delta, m1)
        m2 = torch.where(active, m2 * delta, m2)
        prev_obj = torch.where(active, obj, prev_obj)
        prev_crit = torch.where(active, crit, prev_crit)
        n_done = n_done + active.to(torch.int32)
        done = done | newly
        mse = torch.sum((x - x_true) ** 2) / x.numel() if compute_mse else zero
        rows.append((prev_obj, prev_crit, torch.where(active, dist1, zero),
                     torch.where(active, dist2, zero), mse))
        if (k + 1) % _CHECK_EVERY == 0 and bool(done):
            break

    tr = _traces(rows, 5, max_iter, frozen=(0, 1, 4))
    return CSALSAResult(x=x.cpu().numpy(), objective=tr[0], criterion=tr[1], mses=tr[4],
                        n_iters=int(n_done), distance1=tr[2], distance2=tr[3])


def _identity(v):
    return v


def csalsa_synthesis(
    y,
    H,
    blur: BlurOperator,
    W: Callable,
    WT: Callable,
    mu1: float,
    mu2: float,
    **kwargs,
) -> CSALSAResult:
    """Frame-synthesis C-SALSA (the older `SALSA/csalsa.m` path): unknown =
    synthesis coefficients s, A = blur ∘ W (csalsa.m:377-379), solved by
    the generic loop on blur's device.

    W : coefficients → image (synthesis); WT : image → coefficients
    (analysis).  W must be a Parseval frame (W Wᵀ = I, e.g.
    ops.wavelet.ti_synthesis/ti_analysis), so the LS solve is the Woodbury
    identity with the rfft-diagonal filter |H|²/(|H|² + µ1/µ2)
    (csalsa.m:502,565-567):

        (µ1 I + µ2 Wᵀ AᵀA W)⁻¹ r = (r − Wᵀ irfft(filt · rfft(W r))) / µ1

    Continuation scales µ1 and µ2 together, so the filter stays constant,
    as the reference builds filter_FFT once.  `.x` holds the coefficients;
    the image is W(result.x)."""
    H = torch.as_tensor(H).to(device=blur.device, dtype=blur.cdtype)
    absH2 = H.real ** 2 + H.imag ** 2
    filt = absH2 / (absH2 + mu1 / mu2)

    def A(s):
        return blur.irfft(H * blur.rfft(W(s)))

    def AT(r):
        return WT(blur.irfft(torch.conj(H) * blur.rfft(r)))

    def invLS(r, m1, m2):
        return (r - WT(blur.irfft(filt * blur.rfft(W(r))))) / m1

    y = torch.as_tensor(y, dtype=blur.dtype).to(blur.device)
    return csalsa(y, A, AT, invLS, mu1, mu2, **kwargs)


def csalsa_tv(
    y,
    H,
    mu1: float,
    mu2: float,
    blur: BlurOperator,
    sigma: Optional[float] = None,
    epsilon: Optional[float] = None,
    delta: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-4,
    stop_criterion: int = 1,
    tv_iters: int = 10,
    x_true=None,
    prox_route: Optional[str] = None,
    chambolle_tol: float = 1e-3,
) -> CSALSAResult:
    """TV C-SALSA on the rfft grid (one transform pair an iteration, the
    objective TV(x)), on blur's device and dtype.  The warm-dual prox
    (tv_iters sweeps, tol chambolle_tol) takes resolve_salsa_prox_mode's
    route unless prox_route ('plain', 'A1', 'F', 'H') is given."""
    if stop_criterion not in (1, 2, 3):
        raise ValueError(f"stop_criterion must be 1, 2 or 3, got {stop_criterion}")
    dtype, device = blur.dtype, blur.device
    prox = SALSA_PROX[prox_route or resolve_salsa_prox_mode(blur.shape, device)]
    y = torch.as_tensor(y, dtype=dtype).to(device)
    d = y.numel()
    w = blur.weights
    H = torch.as_tensor(H).to(device=device, dtype=blur.cdtype)
    yhat = blur.rfft_host(y)
    absH2 = H.real ** 2 + H.imag ** 2
    if epsilon is None:
        epsilon = default_epsilon(d, sigma)
    compute_mse = x_true is not None
    if compute_mse:
        x_true = torch.as_tensor(x_true, dtype=dtype).to(device)

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return torch.sum(w * (re * re + im * im)) / d

    z = torch.zeros_like(y)
    x, u, bu, v, bv, pux, puy = z, z, z, z, z, z, z
    m1 = torch.as_tensor(mu1, dtype=dtype).to(device)
    m2 = torch.as_tensor(mu2, dtype=dtype).to(device)
    prev_obj = tv_norm(z)
    prev_crit = torch.linalg.norm(y)
    done = torch.zeros((), dtype=torch.bool, device=device)
    n_done = torch.zeros((), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    rows = []
    for k in range(max_iter):
        active = torch.logical_not(done)
        # Aᵀ(y + v + bv) and the LS solve, fused on the rfft grid
        rhs_hat = blur.rfft(m1 * (u + bu)) + m2 * torch.conj(H) * (yhat + blur.rfft(v + bv))
        xhat = rhs_hat / (m2 * absH2 + m1)
        xn = blur.irfft(xhat)
        un, st = prox(xn - bu, 1.0 / m1, tv_iters, tol=chambolle_tol, duals=(pux, puy))

        Ax = blur.irfft(H * xhat)
        ve = Ax - y - bv
        n_ve = torch.linalg.norm(ve)
        vn = torch.where(n_ve <= epsilon, ve, ve / n_ve * epsilon)
        bvn = bv - (Ax - y - vn)
        bun = bu - (xn - un)

        crit = torch.sqrt(pnorm2(H * xhat - yhat))
        obj = tv_norm(xn)
        if stop_criterion == 1:
            sc = torch.abs(obj - prev_obj) / obj
        elif stop_criterion == 2:
            sc = torch.linalg.norm(xn - x) / torch.linalg.norm(xn)
        else:
            sc = torch.abs(crit - prev_crit) / crit
        if k >= 1:
            done = done | ((sc < tol) & (crit <= epsilon) & active)

        x = torch.where(active, xn, x)
        u = torch.where(active, un, u)
        bu = torch.where(active, bun, bu)
        v = torch.where(active, vn, v)
        bv = torch.where(active, bvn, bv)
        pux = torch.where(active, st.px, pux)
        puy = torch.where(active, st.py, puy)
        m1 = torch.where(active, m1 * delta, m1)
        m2 = torch.where(active, m2 * delta, m2)
        prev_obj = torch.where(active, obj, prev_obj)
        prev_crit = torch.where(active, crit, prev_crit)
        n_done = n_done + active.to(torch.int32)
        mse = torch.sum((x - x_true) ** 2) / d if compute_mse else zero
        rows.append((prev_obj, prev_crit, mse))
        if (k + 1) % _CHECK_EVERY == 0 and bool(done):
            break

    tr = _traces(rows, 3, max_iter, frozen=(0, 1, 2))
    return CSALSAResult(x=x.cpu().numpy(), objective=tr[0], criterion=tr[1], mses=tr[2],
                        n_iters=int(n_done))
