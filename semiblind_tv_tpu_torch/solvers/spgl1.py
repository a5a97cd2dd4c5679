"""SPGL1 — spectral projected gradient for basis pursuit denoise (port of
`semiblind_tv_tpu/solvers/spgl1.py`, SALSA/spgl1_v0.m; van den Berg &
Friedlander's SPGL1).  Two entry points:

  * spg_lasso: min ½‖Ax − b‖²  s.t.  ‖Wx‖₁ ≤ τ
      projected Barzilai–Borwein gradient descent with a nonmonotone
      (last-10) line search and exact sort-based (weighted) L1-ball
      projection.
  * spgl1_bpdn: min ‖Wx‖₁  s.t.  ‖Ax − b‖ ≤ σ
      Newton root-finding on the Pareto curve φ(τ) = ‖r(τ)‖:
      τ ← τ + ‖r‖(‖r‖ − σ)/‖W⁻¹Aᵀr‖_∞ (spgl1_v0.m's options.weights).

Operators: the rfft-diagonal blur (H + blur) or any (A, At) pair of
callables on tensors — e.g. a dense matrix.  Complex data is supported
(spgl1_v0.m's complex surface): the one-norm is the modulus sum, the soft
threshold keeps phases (`torch.sgn`), and the line search's inner products
are the real parts of hermitian products (`_rdot`).

The JAX package's backtracking line search is a `lax.while_loop`; here it
is a masked fixed trip of `max_ls` halvings that keeps the first step
satisfying the sufficient-decrease condition (or the last halving if none
does, as the while loop ends there) — the same step, with no host read per
line-search step.  The outer loop freezes its state once the step test
fires and reads the stop flag on the host every `_CHECK_EVERY`
iterations.  `subspace_min` stays real-only, as in the JAX package; its
refinement is computed every iteration and kept where the support repeats.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from semiblind_tv_tpu_torch.ops.fourier import BlurOperator

__all__ = [
    "SPGL1Result",
    "project_l1_ball",
    "project_weighted_l1_ball",
    "spg_lasso",
    "spgl1_bpdn",
]

_CHECK_EVERY = 32  # iterations between host reads of the stop flag


@dataclasses.dataclass
class SPGL1Result:
    x: np.ndarray
    tau: float
    resid_norm: float
    n_iters: int
    n_newton: int


def _rdot(a, b):
    """Real inner product ⟨a, b⟩ (= Re Σ conj(a)·b); exact for real inputs."""
    s = torch.sum(torch.conj(a) * b)
    return s.real if s.is_complex() else s


def _at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """v[i] for a 0-d index tensor on v's device, −1 the last entry, without
    reading i on the host."""
    return v.index_select(0, torch.remainder(i, v.numel()).reshape(1))[0]


def project_l1_ball(v: torch.Tensor, tau) -> torch.Tensor:
    """Euclidean projection onto {x : ‖x‖₁ ≤ τ} (sort-based, exact); for
    complex v |·| is the modulus and the threshold keeps phases."""
    u = torch.abs(v).reshape(-1)
    s = torch.sort(u, descending=True).values
    cums = torch.cumsum(s, dim=0)
    k = torch.arange(1, u.numel() + 1, dtype=u.dtype, device=u.device)
    ok = s - (cums - tau) / k > 0
    idx = torch.arange(u.numel(), device=u.device)
    rho = torch.max(torch.where(ok, idx, -1))
    theta = torch.clamp((_at(cums, rho) - tau) / (rho + 1.0), min=0.0)
    theta = torch.where(torch.sum(u) <= tau, 0.0, theta)
    return torch.sgn(v) * torch.clamp(torch.abs(v) - theta, min=0.0)


def project_weighted_l1_ball(v: torch.Tensor, tau, w) -> torch.Tensor:
    """Euclidean projection onto {x : Σ w_i|x_i| ≤ τ}, w_i > 0 (exact):
    x_i = sgn(v_i)·max(|v_i| − θ w_i, 0) with the smallest θ ≥ 0 meeting
    the constraint.  Sorting z_i = |v_i|/w_i descending, on the active
    prefix of size k: θ_k = (Σ_{i≤k} w_i|v_i| − τ) / Σ_{i≤k} w_i², valid
    while z_(k) > θ_k.  Reduces to project_l1_ball at w ≡ 1."""
    u = torch.abs(v).reshape(-1)
    w = torch.broadcast_to(torch.as_tensor(w).to(u).reshape(-1), u.shape)
    z = u / w
    order = torch.argsort(-z, stable=True)
    cums_wu = torch.cumsum((w * u)[order], dim=0)
    cums_w2 = torch.cumsum((w * w)[order], dim=0)
    ok = z[order] - (cums_wu - tau) / cums_w2 > 0
    idx = torch.arange(u.numel(), device=u.device)
    rho = torch.max(torch.where(ok, idx, -1))
    theta = torch.clamp((_at(cums_wu, rho) - tau) / _at(cums_w2, rho), min=0.0)
    theta = torch.where(torch.sum(w * u) <= tau, 0.0, theta)
    return (torch.sgn(v).reshape(-1) * torch.clamp(u - theta * w, min=0.0)).reshape(v.shape)


def _resolve_ops(H, blur, A_ops):
    if A_ops is not None:
        return A_ops
    H = torch.as_tensor(H).to(device=blur.device, dtype=blur.cdtype)

    def A(v):
        return blur.irfft(H * blur.rfft(v))

    def At(v):
        return blur.irfft(torch.conj(H) * blur.rfft(v))

    return A, At


def _subspace_step(A, At, x, r, opt_tol, piv_tol=1e-12, cg_iters: int = 8):
    """Active-face refinement (reference spgl1_v0.m:494-549 subspaceMin):
    fixed-trip CGLS on the normal equations restricted to the support and
    the current L1-ball face (a mask and the face projection on every
    direction), then the largest step before a coefficient changes sign.
    Real x only (the reference disables it for complex variables,
    spgl1_v0.m:270-273)."""
    mask = (torch.abs(x) >= opt_tol).to(x.dtype)
    ebar = torch.sign(x) * mask
    ne = torch.clamp(torch.sum(mask), min=1.0)

    def proj(v):
        v = v * mask
        return v - (torch.sum(v * ebar) / ne) * ebar

    s = proj(At(r))
    p = s
    gamma = torch.sum(s * s)
    dx = torch.zeros_like(x)
    for _ in range(cg_iters):
        q = A(proj(p))
        denom = torch.sum(q * q)
        alpha = torch.where(denom > 1e-30, gamma / denom, 0.0)
        dx = dx + alpha * p
        s = s - alpha * proj(At(q))
        gamma_n = torch.sum(s * s)
        beta = torch.where(gamma > 1e-30, gamma_n / gamma, 0.0)
        p = s + beta * p
        gamma = gamma_n
    dx = proj(dx)

    block1 = (mask > 0) & (x < 0) & (dx > piv_tol)
    block2 = (mask > 0) & (x > 0) & (dx < -piv_tol)
    alpha1 = torch.min(torch.where(block1, -x / torch.where(block1, dx, 1.0), torch.inf))
    alpha2 = torch.min(torch.where(block2, -x / torch.where(block2, dx, 1.0), torch.inf))
    alpha = torch.clamp(torch.minimum(alpha1, alpha2), max=1.0)
    return x + alpha * dx


def spg_lasso(
    b,
    H,
    blur: Optional[BlurOperator],
    tau: float,
    x0=None,
    max_iter: int = 200,
    tol: float = 1e-6,
    history: int = 10,
    max_ls: int = 10,
    weights=None,
    A_ops: Optional[Tuple[Callable, Callable]] = None,
    subspace_min: bool = False,
    opt_tol: float = 1e-6,
):
    """Inner LASSO solver; returns (x, resid_norm, grad, n_iters) as
    tensors (n_iters an int), on blur's device or b's.

    weights: positive per-coefficient weights — the constraint becomes
    ‖Wx‖₁ ≤ τ (reference options.weights).  A_ops: (A, At) callables
    replacing the blur operator.  subspace_min: active-face CGLS
    refinement once the support repeats between iterations (reference
    options.subspaceMin; real data only)."""
    if blur is not None:
        b = torch.as_tensor(b, dtype=blur.dtype).to(blur.device)
    else:
        b = torch.as_tensor(b)
    A, At = _resolve_ops(H, blur, A_ops)
    rdtype = b.real.dtype if b.is_complex() else b.dtype
    device = b.device

    if weights is None:
        def project(v):
            return project_l1_ball(v, tau)
    else:
        wgt = torch.as_tensor(weights).to(device=device, dtype=rdtype)

        def project(v):
            return project_weighted_l1_ball(v, tau, wgt)

    def f_and_g(x):
        r = A(x) - b
        return 0.5 * _rdot(r, r), At(r)

    if x0 is None:
        x0 = torch.zeros_like(b) if A_ops is None else torch.zeros_like(At(b))
    x = project(torch.as_tensor(x0).to(b))
    f, g = f_and_g(x)
    fbuf = f.repeat(history)
    alpha = 1.0 / torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    prev_nnz = torch.abs(x) >= opt_tol
    done = torch.zeros((), dtype=torch.bool, device=device)
    n_done = torch.zeros((), dtype=torch.int32, device=device)
    for k in range(max_iter):
        active = torch.logical_not(done)
        fmax = torch.max(fbuf)
        # backtracking: the first of alpha·2^-j (j < max_ls) with sufficient
        # decrease, else alpha·2^-max_ls
        a = alpha
        a_fin = alpha
        found = torch.zeros((), dtype=torch.bool, device=device)
        for _ in range(max_ls):
            xn = project(x - a * g)
            rn = A(xn) - b
            suff = 0.5 * _rdot(rn, rn) <= fmax + 1e-4 * _rdot(g, xn - x)
            a_fin = torch.where(found | ~suff, a_fin, a)
            found = found | suff
            a = a * 0.5
        a_fin = torch.where(found, a_fin, a)
        xn = project(x - a_fin * g)

        if subspace_min:
            nnz = torch.abs(xn) >= opt_tol
            trigger = torch.all(nnz == prev_nnz) & active
            xn = torch.where(trigger, project(_subspace_step(A, At, xn, b - A(xn), opt_tol)), xn)
            prev_nnz = torch.where(active, nnz, prev_nnz)

        fn, gn = f_and_g(xn)
        s = xn - x
        sy = _rdot(s, gn - g)
        alpha_n = torch.where(sy > 1e-12, torch.clamp(_rdot(s, s) / sy, 1e-6, 1e6), 1.0)
        step = torch.linalg.norm(s) / torch.clamp(torch.linalg.norm(xn), min=1.0)
        newly = (step < tol) & active

        x = torch.where(active, xn, x)
        g = torch.where(active, gn, g)
        f = torch.where(active, fn, f)
        alpha = torch.where(active, alpha_n, alpha)
        fbuf = torch.where(active, torch.cat([fn[None], fbuf[:-1]]), fbuf)
        done = done | newly
        n_done = n_done + active.to(torch.int32)
        if (k + 1) % _CHECK_EVERY == 0 and bool(done):
            break
    return x, torch.sqrt(2.0 * f), g, int(n_done)


def spgl1_bpdn(
    b,
    H,
    blur: Optional[BlurOperator],
    sigma: float,
    max_newton: int = 10,
    inner_iter: int = 150,
    tol: float = 1e-3,
    weights=None,
    A_ops: Optional[Tuple[Callable, Callable]] = None,
    subspace_min: bool = False,
) -> SPGL1Result:
    """(Weighted) basis pursuit denoise by Pareto-curve Newton iteration:
    min ‖Wx‖₁ s.t. ‖Ax − b‖ ≤ σ, with φ'(τ) = −‖W⁻¹Aᵀr‖_∞/‖r‖ (the dual
    norm of the weighted one-norm).  Reads ‖r‖ and ‖W⁻¹Aᵀr‖_∞ on the host
    once a Newton step, as the JAX package does."""
    if blur is not None:
        b = torch.as_tensor(b, dtype=blur.dtype).to(blur.device)
    else:
        b = torch.as_tensor(b)
    A, At = _resolve_ops(H, blur, A_ops)
    tau = 0.0
    x = torch.zeros_like(b) if A_ops is None else torch.zeros_like(At(b))
    resid = float(torch.linalg.norm(b))
    wgt = None if weights is None else torch.as_tensor(weights).to(b)
    n_total = 0
    n_newton = 0
    for _ in range(max_newton):
        if resid <= sigma * (1.0 + tol):
            break
        z = At(A(x) - b)
        if wgt is not None:
            z = z / wgt
        g_inf = max(float(torch.max(torch.abs(z))), 1e-12)
        tau = tau + resid * (resid - sigma) / g_inf
        x, r, _, n = spg_lasso(
            b, H, blur, tau, x0=x, max_iter=inner_iter, weights=weights, A_ops=A_ops,
            # the reference disables subspace minimisation for complex x
            # (spgl1_v0.m:270-273)
            subspace_min=subspace_min and not b.is_complex(),
        )
        resid = float(r)
        n_total += n
        n_newton += 1
    return SPGL1Result(x=x.cpu().numpy(), tau=float(tau), resid_norm=resid,
                       n_iters=n_total, n_newton=n_newton)
