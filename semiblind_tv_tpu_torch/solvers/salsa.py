"""SALSA — ADMM MAP solver for min_x ½‖y − Ax‖² + τ·TV(x) (port of
`semiblind_tv_tpu/solvers/salsa.py`, SALSA_v2.m:156-494).

Per outer iteration (SALSA_v2.m:423-440):
  u ← prox_{τ/µ·TV}(x − b)          Chambolle, `tv_iters` sweeps, duals warm-
                                    started across outer iterations
                                    (SALSA_v2.m:429): on a CUDA tensor the
                                    warm form of the kernel that
                                    `resolve_salsa_prox_mode` picks
  x ← irfft2((conj(H)·ŷ + µ·rfft2(u + b)) / (|H|² + µ))
  b ← b + u − x
Stop criteria 1/2/3 (SALSA_v2.m:455-469), evaluated from the second outer
iteration on; the demos use criterion 1 with 500 outer iterations.

As in the JAX package the state freezes once the criterion fires (masked
updates, no host sync per iteration).  The port also checks the stop flag
on the host every `_CHECK_EVERY` iterations and leaves the loop once it is
set; the remaining trace entries are then filled with the frozen values, so
the result equals running all `max_iter` iterations.

Spans (runtime/profiling.py, while the recorder is on): one `salsa.iter`
an outer iteration, the prox call in it as `kernel.prox`; the prox's sweep
counts are folded into their counters after the traces' host read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.tv import tv_norm
from semiblind_tv_tpu_torch.ops.tv_blocked_cuda import blocked_rung, chambolle_prox_blocked
from semiblind_tv_tpu_torch.ops.tv_cuda import chambolle_prox_cuda, chambolle_prox_plain
from semiblind_tv_tpu_torch.runtime.profiling import fold_sweeps, span

__all__ = ["SALSAResult", "salsa_tv", "soft_threshold", "l1_norm", "resolve_salsa_prox_mode",
           "SALSA_PROX"]

_CHECK_EVERY = 32  # outer iterations between host reads of the stop flag


def soft_threshold(x, T):
    """Soft-threshold shrinkage (reference SALSA/soft.m:1-8, the default Psi)."""
    T = torch.as_tensor(T, dtype=x.dtype, device=x.device)
    y = torch.clamp(torch.abs(x) - T, min=0.0)
    return torch.where(T == 0, x, y / (y + T) * x)


def l1_norm(x):
    """‖x‖₁ (the default Φ of the reference's solvers)."""
    return torch.sum(torch.abs(x))


def resolve_salsa_prox_mode(shape, device) -> str:
    """The warm-dual prox of the SALSA inner solve for an (M, N) image on
    `device`, by the size ladder of the JAX package's resolve_salsa_prox_mode:
    'A1' up to 512² (chambolle_prox_cuda, the counterpart of the whole-image
    kernel), 'F' up to 1024² pixels and 'H' above (chambolle_prox_blocked,
    the counterpart of the tiled and streamed kernels); 'plain' on the CPU.
    Launches nothing.

    The blocked kernel sums the early-exit residual over its tiles in
    another order than the plain version.  At a fixed sweep count its f is
    bit-equal to the plain prox's, but a residual on the edge of tol can
    stop on another sweep, and across many warm-started outer iterations
    that drifts: the JAX package's streamed SALSA at 2048² ended about 3e-4
    relative from the XLA prox after 100 outer iterations (RESULTS.md r5)."""
    if torch.device(device).type != "cuda":
        return "plain"
    return {None: "A1", "tiled": "F", "streamed": "H"}[blocked_rung(shape)]


# the warm-dual prox of each route resolve_salsa_prox_mode names
SALSA_PROX = {"plain": chambolle_prox_plain, "A1": chambolle_prox_cuda,
              "F": chambolle_prox_blocked, "H": chambolle_prox_blocked}


@dataclasses.dataclass
class SALSAResult:
    x: np.ndarray
    objective: np.ndarray       # length max_iter+1 (objective[0] = initial value)
    distance: np.ndarray
    mses: np.ndarray
    criterion: np.ndarray
    n_iters: int
    op_counts: Dict[str, int]   # callcounter parity: applies of A / AT / invLS


def salsa_tv(
    y,
    H,
    tau,
    mu,
    blur: BlurOperator,
    max_iter: int = 500,
    tol: float = 1e-5,
    tv_iters: int = 10,
    stop_criterion: int = 1,
    x_true=None,
    chambolle_tau: float = 0.249,
    chambolle_tol: float = 1e-3,
    prox_route: Optional[str] = None,
) -> SALSAResult:
    """TV-regularised SALSA with warm-started Chambolle duals, x0 = 0
    (SALSA_v2.m:379, TVINITIALIZATION=1), on blur's device and dtype.
    prox_route overrides resolve_salsa_prox_mode ('plain', 'A1', 'F', 'H')."""
    if stop_criterion not in (1, 2, 3):
        raise ValueError(f"stop_criterion must be 1, 2 or 3, got {stop_criterion}")
    dtype, device = blur.dtype, blur.device
    prox = SALSA_PROX[prox_route or resolve_salsa_prox_mode(blur.shape, device)]
    d = blur.dim
    w = blur.weights
    y = torch.as_tensor(y, dtype=dtype).to(device)
    H = torch.as_tensor(H).to(device=device, dtype=blur.cdtype)
    tau = torch.as_tensor(tau, dtype=dtype).to(device)
    mu = torch.as_tensor(mu, dtype=dtype).to(device)
    tol_t = torch.as_tensor(tol, dtype=dtype).to(device)
    compute_mse = x_true is not None
    if compute_mse:
        x_true = torch.as_tensor(x_true, dtype=dtype).to(device)

    Hre, Him = H.real, H.imag
    yhat = blur.rfft(y)
    ATy_hat = torch.conj(H) * yhat
    inv_filter = 1.0 / (Hre * Hre + Him * Him + mu)
    thresh = tau / mu
    norm_y2 = torch.sum(y * y)

    def pnorm2(rhat):
        re, im = rhat.real, rhat.imag
        return torch.sum(w * (re * re + im * im)) / d

    x = torch.zeros_like(y)
    bu, pux, puy = x, x, x
    obj0 = 0.5 * norm_y2  # resid = y − A·0
    prev_obj = obj0
    done = torch.zeros((), dtype=torch.bool, device=device)
    n_done = torch.zeros((), dtype=torch.int32, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    tr = torch.zeros((4, max_iter), dtype=dtype, device=device)  # obj, dist, mse, crit

    ran = 0
    for k in range(max_iter):
        with span("salsa.iter"):
            active = torch.logical_not(done)
            with span("kernel.prox"):
                un, st = prox(
                    x - bu, thresh, tv_iters, tau=chambolle_tau, tol=chambolle_tol,
                    duals=(pux, puy),
                )
            r = un + bu
            rhat = blur.rfft(r)
            xhat_n = inv_filter * (ATy_hat + mu * rhat)
            xn = blur.irfft(xhat_n)
            bun = bu + (un - xn)

            # objective via Parseval: ½‖y − A x‖² + τ TV(u)
            resid2 = pnorm2(yhat - H * xhat_n)
            obj = 0.5 * resid2 + tau * tv_norm(un)
            dist = torch.linalg.norm(xn - un) / torch.sqrt(
                torch.sum(xn * xn) + torch.sum(un * un))
            if stop_criterion == 1:
                crit = torch.abs(obj - prev_obj) / prev_obj
            elif stop_criterion == 2:
                crit = torch.linalg.norm(xn - x) / torch.linalg.norm(xn)
            else:
                crit = obj
            # the reference only tests the stop from the 2nd outer iteration
            # (SALSA_v2.m:453 `if (outer>1)`)
            newly_done = torch.logical_and(active, crit < tol_t) if k >= 1 else zero.bool()

            x = torch.where(active, xn, x)
            bu = torch.where(active, bun, bu)
            pux = torch.where(active, st.px, pux)
            puy = torch.where(active, st.py, puy)
            prev_obj = torch.where(active, obj, prev_obj)
            n_done = n_done + active.to(torch.int32)
            done = torch.logical_or(done, newly_done)

            mse = torch.sum((x - x_true) ** 2) / d if compute_mse else zero
            tr[:, k] = torch.stack([
                prev_obj,
                torch.where(active, dist, zero),
                mse,
                torch.where(active, crit, zero),
            ])
            ran = k + 1
            if ran % _CHECK_EVERY == 0 and bool(done):
                break

    traces = tr.cpu().numpy()
    fold_sweeps()
    if ran < max_iter:
        # frozen tail: objective and mse hold, distance and criterion are 0
        traces[0, ran:] = traces[0, ran - 1]
        traces[2, ran:] = traces[2, ran - 1]
    n_iters = int(n_done)
    mses = traces[2]
    if compute_mse:
        mse0 = float(torch.sum(x_true ** 2) / d)
        mses = np.concatenate([[mse0], mses])
    # operator-apply accounting (reference callcounter, run_Gaussian_demo.m:
    # 210-218): per outer iteration SALSA_v2 applies A once (objective) and
    # invLS once; AT once up front
    op_counts = {"A": 1 + n_iters, "AT": 1, "invLS": n_iters}
    return SALSAResult(
        x=x.cpu().numpy(),
        objective=np.concatenate([[float(obj0)], traces[0]]),
        distance=traces[1],
        mses=mses,
        criterion=traces[3],
        n_iters=n_iters,
        op_counts=op_counts,
    )
