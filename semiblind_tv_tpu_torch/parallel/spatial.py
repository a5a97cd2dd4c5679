"""Spatial (row-block) sharding: halo-exchanged TV stencils and 2-D
decomposed DFT transforms for images too large for one card (port of
`semiblind_tv_tpu/parallel/spatial.py`).

  * The image's ROW axis is split over a 1-D ('space',) mesh
    (parallel/mesh.make_spatial_mesh): each rank holds a contiguous
    (M/S, N) row block.
  * The TV stencils (the Neumann divergence and forward gradient of the
    Chambolle prox, the circular differences of TVnorm) need one row of
    halo per sweep in each direction, which the ranks swap with their row
    neighbours (`batch_isend_irecv`, O(N) bytes a sweep).
  * rfft2 / irfft2 use the matmul-DFT formulation (ops/fourier.py::
    rdft_matrices): the row transform is local, and the column transform,
    an (M, M) contraction over the split axis, is a local partial
    `torch.matmul` (full float32: callers keep TF32 off) followed by a
    reduce-scatter (`reduce_scatter_tensor`), so the result stays split by
    rows and no rank ever holds the whole image.
  * `spatial_salsa_tv` composes these into the SALSA MAP solve, and
    `run_sapg_spatial` into the whole single-chain SAPG estimator, each
    the single-device computation on the global image up to the order of
    the sums.

Every function runs on each rank of the mesh with that rank's rows and
takes the mesh's `group` (default: the default group); the S ranks call it
together.  Like the JAX package's spatial path, this one launches no hand
kernel: it is plain PyTorch on whatever device the rows live on.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from semiblind_tv_tpu_torch.ops.fourier import rdft_matrices, rfft_weights
from semiblind_tv_tpu_torch.parallel.mesh import SPACE_AXIS, mesh_device
from semiblind_tv_tpu_torch.runtime.checkpoint import load_checkpoint_arrays, save_checkpoint_arrays
from semiblind_tv_tpu_torch.sapg.estimator import (
    _host,
    _merge_traces,
    assemble_result,
    run_segmented_scan,
)
from semiblind_tv_tpu_torch.solvers.salsa import _CHECK_EVERY

__all__ = [
    "shard_rows",
    "unshard_rows",
    "spatial_tv_norm",
    "spatial_divergence",
    "spatial_forward_gradient",
    "spatial_chambolle_prox",
    "spatial_rfft2",
    "spatial_irfft2",
    "spatial_blur_apply",
    "spatial_salsa_tv",
    "spatial_myula_step",
    "run_sapg_spatial",
]


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _index(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def shard_rows(x, group=None):
    """This rank's contiguous row block of a global (M, ...) array."""
    S, r = _size(group), _index(group)
    M = x.shape[0]
    if M % S != 0:
        raise ValueError(f"rows {M} not divisible by mesh size {S}")
    Ml = M // S
    return x[r * Ml:(r + 1) * Ml]


def unshard_rows(x_local: torch.Tensor, group=None) -> torch.Tensor:
    """The global array from every rank's row block (all_gather)."""
    S = _size(group)
    if S == 1:
        return x_local
    parts = [torch.empty_like(x_local) for _ in range(S)]
    dist.all_gather(parts, x_local.contiguous(), group=group)
    return torch.cat(parts)


def _psum(v: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks, on the device."""
    if _size(group) > 1:
        v = v.clone()
        dist.all_reduce(v, group=group)
    return v


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------

def _pass_row(send: torch.Tensor, group, down: bool, circular: bool = False) -> torch.Tensor:
    """Each rank sends `send` to the next rank (down) or the previous one
    and returns what it received from the other side: zeros at the mesh's
    end, or, circular, the wrapped rank's row."""
    S, r = _size(group), _index(group)
    if S == 1:
        return send.clone() if circular else torch.zeros_like(send)
    recv = torch.zeros_like(send)
    dst, src = (r + 1, r - 1) if down else (r - 1, r + 1)
    ops = []
    if circular or 0 <= dst < S:
        ops.append(dist.P2POp(dist.isend, send.contiguous(),
                              dist.get_global_rank(group, dst % S), group))
    if circular or 0 <= src < S:
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src % S), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _is_last(group) -> bool:
    return _index(group) == _size(group) - 1


# ---------------------------------------------------------------------------
# TV stencils with halos (semantics of ops/tv.py on the GLOBAL image)
# ---------------------------------------------------------------------------

def spatial_tv_norm(x: torch.Tensor, group=None) -> torch.Tensor:
    """Circular-difference TV (utils/TVnorm.m) of the global image; the row
    above the block's first wraps across ranks (circular exchange)."""
    above = _pass_row(x[-1:], group, down=True, circular=True)
    dh = x - torch.roll(x, 1, dims=1)
    dv = x - torch.cat([above, x[:-1]], dim=0)
    return _psum(torch.sum(torch.sqrt(dh * dh + dv * dv)), group)


def spatial_divergence(p1: torch.Tensor, p2: torch.Tensor, group=None) -> torch.Tensor:
    """Neumann divergence (ops/tv.divergence) of row-split dual fields:
    u[0] = p1[0]; u[i] = p1[i] − p1[i−1]; u[M−1] = −p1[M−1] on the global
    rows.  The first rank's zero halo is the boundary condition."""
    above = _pass_row(p1[-1:], group, down=True)
    u = p1 - torch.cat([above, p1[:-1]], dim=0)
    if _is_last(group):
        u = torch.cat([u[:-1], -p1[-1:]], dim=0)
    v = torch.cat([p2[:, :1], p2[:, 1:-1] - p2[:, :-2], -p2[:, -1:]], dim=1)
    return u + v


def spatial_forward_gradient(u: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences, zero at the global last row and column
    (ops/tv.forward_gradient)."""
    below = _pass_row(u[:1], group, down=False)
    dux = torch.cat([u[1:], below], dim=0) - u
    if _is_last(group):
        dux = torch.cat([dux[:-1], torch.zeros_like(u[-1:])], dim=0)
    duy = torch.cat([u[:, 1:] - u[:, :-1], torch.zeros_like(u[:, :1])], dim=1)
    return dux, duy


def spatial_chambolle_prox(
    g: torch.Tensor,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    group=None,
):
    """Halo-exchanged Chambolle dual ascent: ops/tv.chambolle_prox on the
    global image (masked fixed trip, warm-startable duals).  A sweep swaps
    two one-row halos and all-reduces the residual on the device (no host
    read).  Returns (f, (px, py, sweeps, err))."""
    if duals is None:
        px, py = torch.zeros_like(g), torch.zeros_like(g)
    else:
        px, py = duals
    glam = g / lam
    k = torch.zeros((), dtype=torch.int32, device=g.device)
    err = torch.full((), float("inf"), dtype=g.dtype, device=g.device)
    active = torch.ones((), dtype=torch.bool, device=g.device)
    for _ in range(max_iter):
        u = spatial_divergence(px, py, group) - glam
        upx, upy = spatial_forward_gradient(u, group)
        tmp = torch.sqrt(upx * upx + upy * upy)
        rx = -upx + tmp * px
        ry = -upy + tmp * py
        step_err = torch.sqrt(_psum(torch.sum(rx * rx + ry * ry), group))
        denom = 1.0 + tau * tmp
        px = torch.where(active, (px + tau * upx) / denom, px)
        py = torch.where(active, (py + tau * upy) / denom, py)
        err = torch.where(active, step_err, err)
        k = k + active.to(torch.int32)
        active = torch.logical_and(active, step_err > tol)
    f = g - lam * spatial_divergence(px, py, group)
    return f, (px, py, k, err)


# ---------------------------------------------------------------------------
# Row-split matmul-DFT transforms (reduce-scattered column contraction)
# ---------------------------------------------------------------------------

def _local_cols(mat: torch.Tensor, rows_local: int, group) -> torch.Tensor:
    """This rank's (M, M/S) column slice of an (M, M) factor matrix."""
    r = _index(group)
    return mat[:, r * rows_local:(r + 1) * rows_local]


def _reduce_scatter(part: torch.Tensor, group) -> torch.Tensor:
    """Sum `part` over the ranks and keep this rank's block of rows."""
    S = _size(group)
    if S == 1:
        return part
    out = torch.empty((part.shape[0] // S,) + tuple(part.shape[1:]), dtype=part.dtype,
                      device=part.device)
    with warnings.catch_warnings():   # the name both torch versions of the port know
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, part.contiguous(), group=group)
    return out


def _mats(mats, like):
    return {k: torch.as_tensor(v).to(device=like.device, dtype=like.dtype)
            for k, v in mats.items()}


def spatial_rfft2(x: torch.Tensor, mats, group=None):
    """rfft2 of a row-split real image → row-split half-spectrum (re, im).
    The row transform is local; the column contraction a local partial
    matmul and a reduce-scatter."""
    m = _mats(mats, x)
    Ml = x.shape[0]
    yre = torch.matmul(x, m["CN"])
    yim = -torch.matmul(x, m["SN"])
    CMl, SMl = _local_cols(m["CM"], Ml, group), _local_cols(m["SM"], Ml, group)
    zre = _reduce_scatter(torch.matmul(CMl, yre) + torch.matmul(SMl, yim), group)
    zim = _reduce_scatter(torch.matmul(CMl, yim) - torch.matmul(SMl, yre), group)
    return zre, zim


def spatial_irfft2(zre: torch.Tensor, zim: torch.Tensor, mats, group=None) -> torch.Tensor:
    """irfft2 of a row-split half-spectrum (re, im) → row-split real image:
    the column contraction first (partial matmul, reduce-scatter), then the
    local Hermitian-weighted row transform."""
    m = _mats(mats, zre)
    M = m["CM"].shape[0]
    Ml = zre.shape[0]
    CMl, SMl = _local_cols(m["CM"], Ml, group), _local_cols(m["SM"], Ml, group)
    yre = _reduce_scatter(torch.matmul(CMl, zre) - torch.matmul(SMl, zim), group) / M
    yim = _reduce_scatter(torch.matmul(CMl, zim) + torch.matmul(SMl, zre), group) / M
    return torch.matmul(yre, m["WCT"]) - torch.matmul(yim, m["WST"])


def spatial_blur_apply(x, Hre, Him, mats, group=None, adjoint: bool = False):
    """A x (or Aᵀ x) of a row-split image with row-split OTF planes."""
    zre, zim = spatial_rfft2(x, mats, group)
    if adjoint:
        re, im = Hre * zre + Him * zim, Hre * zim - Him * zre
    else:
        re, im = Hre * zre - Him * zim, Hre * zim + Him * zre
    return spatial_irfft2(re, im, mats, group)


# ---------------------------------------------------------------------------
# Row-split MYULA step
# ---------------------------------------------------------------------------

def _grad_f(Xre, Xim, Hre, Him, yhre, yhim, mats, group):
    """irfft2(conj(H)·(H·X̂ − ŷ)) of the row-split planes."""
    rre = Hre * Xre - Him * Xim - yhre
    rim = Hre * Xim + Him * Xre - yhim
    return spatial_irfft2(Hre * rre + Him * rim, Hre * rim - Him * rre, mats, group)


def spatial_myula_step(x, prox, z, Hre, Him, yhre, yhim, mats, gamma, lam, sigma2, group=None,
                       positivity: bool = True):
    """One MYULA update of a row-split chain state (samplers/myula.py;
    gradF through the split transforms)."""
    zre, zim = spatial_rfft2(x, mats, group)
    gradF = _grad_f(zre, zim, Hre, Him, yhre, yhim, mats, group) / sigma2
    xn = x + gamma * (prox - x) / lam - gamma * gradF + torch.sqrt(
        torch.as_tensor(2.0 * gamma, dtype=x.dtype)) * z
    return torch.abs(xn) if positivity else xn


# ---------------------------------------------------------------------------
# Row-split SALSA MAP solve
# ---------------------------------------------------------------------------

def spatial_salsa_tv(
    y,
    H,
    tau,
    mu,
    mesh,
    max_iter: int = 500,
    tol: float = 1e-5,
    tv_iters: int = 10,
    dtype=torch.float32,
    chambolle_tau: float = 0.249,
    chambolle_tol: float = 1e-3,
):
    """Row-split SALSA (solvers/salsa.salsa_tv, stop criterion 1) over a
    ('space',) mesh.  Returns (x, objective trace (max_iter,), n_iters)
    with x the global image on every rank.

    y: global (M, N) observation; H: global (M, N//2+1) OTF.  The prox
    swaps one-row halos each sweep, the least-squares step runs through the
    reduce-scattered matmul DFTs, and the objective all-reduces two sums an
    iteration; a stopped run is held by masks, and the stop flag is read on
    the host every 32 iterations."""
    group = mesh.get_group(SPACE_AXIS)
    device = mesh_device(mesh)
    y = torch.as_tensor(y).to(device=device, dtype=dtype)
    H = torch.as_tensor(H).to(device)
    M, N = y.shape
    d = M * N
    mats = rdft_matrices((M, N), dtype, device)
    w = rfft_weights((M, N), dtype, device)
    y_l = shard_rows(y, group)
    Hre = shard_rows(H.real.to(dtype), group)
    Him = shard_rows(H.imag.to(dtype), group)
    tau = torch.as_tensor(tau, dtype=dtype, device=device)
    mu = torch.as_tensor(mu, dtype=dtype, device=device)

    yhre, yhim = spatial_rfft2(y_l, mats, group)
    ATy_re, ATy_im = Hre * yhre + Him * yhim, Hre * yhim - Him * yhre
    inv_f = 1.0 / (Hre * Hre + Him * Him + mu)
    thresh = tau / mu

    def pnorm2(re, im):
        return _psum(torch.sum(w * (re * re + im * im)), group) / d

    x = torch.zeros_like(y_l)
    u, bu, pux, puy = x, x, x, x
    prev_obj = 0.5 * _psum(torch.sum(y_l * y_l), group)
    done = torch.zeros((), dtype=torch.bool, device=device)
    n_done = torch.zeros((), dtype=torch.int32, device=device)
    objs = torch.empty((max_iter,), dtype=dtype, device=device)
    ran = 0
    for k in range(max_iter):
        active = torch.logical_not(done)
        un, (pxn, pyn, _, _) = spatial_chambolle_prox(
            x - bu, thresh, tv_iters, tau=chambolle_tau, tol=chambolle_tol, duals=(pux, puy),
            group=group)
        rre, rim = spatial_rfft2(un + bu, mats, group)
        xh_re, xh_im = inv_f * (ATy_re + mu * rre), inv_f * (ATy_im + mu * rim)
        xn = spatial_irfft2(xh_re, xh_im, mats, group)
        bun = bu + (un - xn)
        obj = 0.5 * pnorm2(yhre - (Hre * xh_re - Him * xh_im),
                           yhim - (Hre * xh_im + Him * xh_re)) + tau * spatial_tv_norm(un, group)
        crit = torch.abs(obj - prev_obj) / prev_obj
        newly = torch.logical_and(active, crit < tol) if k >= 1 else torch.zeros_like(done)
        x, u, bu = (torch.where(active, a, b) for a, b in ((xn, x), (un, u), (bun, bu)))
        pux, puy = torch.where(active, pxn, pux), torch.where(active, pyn, puy)
        prev_obj = torch.where(active, obj, prev_obj)
        objs[k] = prev_obj
        n_done = n_done + active.to(torch.int32)
        done = torch.logical_or(done, newly)
        ran = k + 1
        if ran % _CHECK_EVERY == 0 and bool(done):
            break
    out = objs.cpu().numpy()
    out[ran:] = out[ran - 1]   # the frozen tail of a stopped run
    return unshard_rows(x, group), out, int(n_done)


# ---------------------------------------------------------------------------
# The row-split SAPG estimator (one chain, giant-image mode)
# ---------------------------------------------------------------------------

def _spatial_otf(kernel, Fx, Fy, rows_local, group):
    """This rank's rows of the corner-embedded OTF (re, im): row r of the
    OTF is (Fxᵀ k Fy)[r] (ops/fourier.otf_rfft), so Fx's columns are cut to
    the rank's rows first and the OTF is never whole on one rank."""
    Fxl = _local_cols(Fx, rows_local, group)
    H = torch.matmul(torch.matmul(Fxl.T, kernel.to(Fxl.dtype)), Fy)
    return H.real, H.imag


def _trace_keys(psf_names):
    return (["theta", "sigma2", "logPi", "gX", "G_t", "G_s"]
            + [f"G_{n}" for n in psf_names] + list(psf_names))


def run_sapg_spatial(
    problem, mesh, generator=None, x0=None, noise=None,
    checkpoint_every=None, checkpoint_path=None, checkpoint_backend="npz",
    nan_guard=True, max_restores=1, fault_hook=None,
):
    """Warm-up + SAPG + EB extraction with the IMAGE split by rows over a
    ('space',) mesh: one Markov chain whose state does not fit, or need not
    fit, on one card.  Every rank calls it with the same problem.

    The math and the order of the iterations are those of
    sapg/estimator.py at one chain with the linear SA updates (the JAX
    package's spatial estimator has no log-scale options; they raise here).
    An iteration's traffic: 4 reduce-scatters (the transforms), two one-row
    halos a prox sweep, and the all-reduced sums.  The noise is drawn whole
    on every rank — (1, M, N) from `generator`, as run_sapg(n_chains=1)
    draws it, or asked of `noise` — and cut to the rank's rows, so the
    trajectory is run_sapg(problem, n_chains=1)'s up to the order of the
    sums.  checkpoint/resume and the NaN guard as run_sapg (npz in a
    one-process world, the directory backend "orbax" in a larger one; the
    carry (X, X̂ re, X̂ im, prox, θ, σ², params) is the rank's and
    fault_hook gets it).  Returns the SAPGResult bundle with X_last (1, M, N)."""
    cfg = problem.cfg
    sapg = cfg.sapg
    if sapg.theta_log_scale or sapg.sigma_log_scale or sapg.psf_log_scale:
        raise ValueError("run_sapg_spatial runs the linear SA updates only")
    group = mesh.get_group(SPACE_AXIS)
    device = mesh_device(mesh)
    if problem.device != device:
        raise ValueError(f"problem on {problem.device}, this rank's device is {device}")
    if dist.get_world_size() > 1 and checkpoint_path is not None and checkpoint_backend == "npz":
        raise ValueError("a multi-process run checkpoints to a directory: "
                         "checkpoint_backend='orbax'")
    blur = problem.blur
    dtype = blur.dtype
    M, N = blur.shape
    d = blur.dim
    S, r = _size(group), _index(group)
    if M % S != 0:
        raise ValueError(f"rows {M} not divisible by mesh size {S}")
    Ml = M // S
    rows = slice(r * Ml, (r + 1) * Ml)

    model = problem.model
    theta_spec = cfg.theta
    psf_specs = cfg.psf_params
    psf_names = tuple(s.name for s in psf_specs)
    free_names = tuple(s.name for s in psf_specs if not s.fix)
    sigma_fix = problem.sigma_spec().fix
    d_scale = sapg.d_scale if sapg.d_scale is not None else 0.01 / theta_spec.init
    mats = rdft_matrices((M, N), dtype, device)
    w = rfft_weights((M, N), dtype, device)
    Fx, Fy = blur.factors

    def as_t(v):
        return torch.as_tensor(v, dtype=dtype).to(device)

    theta0, sigma0 = as_t(theta_spec.init), as_t(problem.sigma2_init)
    params0 = {k: as_t(v) for k, v in cfg.init_psf_params().items()}
    gam, lam = as_t(problem.gamma), as_t(problem.lambda_myula)
    s2_lo, s2_hi = as_t(problem.sigma2_box[0]), as_t(problem.sigma2_box[1])
    s2g = torch.sqrt(2.0 * gam)
    n_warm = max(sapg.warmup - 1, 0)

    H0 = blur.otf_host(model.kernel(params0))
    H0re, H0im = H0.real[rows].contiguous(), H0.imag[rows].contiguous()
    yhre, yhim = spatial_rfft2(problem.y[rows].contiguous(), mats, group)
    x0 = problem.y if x0 is None else torch.as_tensor(x0, dtype=dtype).to(device)
    X0 = x0[rows].contiguous()

    if noise is None:
        if generator is None:
            raise ValueError("run_sapg_spatial needs a generator or a noise source")

        def noise(shape):
            return torch.randn(shape, generator=generator, dtype=dtype, device=device)

    def draw():
        return noise((1, M, N))[0, rows]

    def prox_of(Xl, lam_theta):
        return spatial_chambolle_prox(Xl, lam_theta, sapg.chambolle_iters,
                                      tau=sapg.chambolle_tau, tol=sapg.chambolle_tol,
                                      group=group)[0]

    def pnorm2(re, im):
        return _psum(torch.sum(w * (re * re + im * im)), group) / d

    def pdot(are, aim, bre, bim):
        return _psum(torch.sum(w * (are * bre + aim * bim)), group) / d

    def otfs_local(params):
        k, dks = model.kernel_and_grads(params)
        return (_spatial_otf(k, Fx, Fy, Ml, group),
                {n: _spatial_otf(dks[n], Fx, Fy, Ml, group) for n in free_names})

    def advance(Xl, Xre, Xim, prox, Hre, Him, sigma2, theta, positivity):
        gradF = _grad_f(Xre, Xim, Hre, Him, yhre, yhim, mats, group) / sigma2
        Xn = Xl + gam * (prox - Xl) / lam - gam * gradF + s2g * draw()
        if positivity:
            Xn = torch.abs(Xn)
        proxn = prox_of(Xn, lam * theta)
        Xre_n, Xim_n = spatial_rfft2(Xn, mats, group)
        return Xn, Xre_n, Xim_n, proxn

    def logpi_of(Xre, Xim, Xl, Hre, Him, sigma2, theta):
        res2 = pnorm2(Hre * Xre - Him * Xim - yhre, Hre * Xim + Him * Xre - yhim)
        tv = spatial_tv_norm(Xl, group)
        return res2, tv, -res2 / (2.0 * sigma2) - theta * tv

    def warm_all():
        Xre, Xim = spatial_rfft2(X0, mats, group)
        carry = (X0, Xre, Xim, prox_of(X0, lam * theta0))
        logpi_wu = torch.empty((n_warm,), dtype=dtype, device=device)
        for t in range(n_warm):
            Xn, Xre_n, Xim_n, proxn = advance(*carry, H0re, H0im, sigma0, theta0, True)
            logpi_wu[t] = logpi_of(Xre_n, Xim_n, Xn, H0re, H0im, sigma0, theta0)[2]
            carry = (Xn, Xre_n, Xim_n, proxn)
        logpi0 = logpi_of(carry[1], carry[2], carry[0], H0re, H0im, sigma0, theta0)[2]
        return carry + (theta0, sigma0, dict(params0)), logpi_wu, logpi0

    def step(carry, ii):
        Xl, Xre, Xim, prox, theta, sigma2, params = carry
        (Hre, Him), dHs = otfs_local(params)
        Xn, Xre_n, Xim_n, proxn = advance(Xl, Xre, Xim, prox, Hre, Him, sigma2, theta,
                                          sapg.positivity)
        Rre = Hre * Xre_n - Him * Xim_n - yhre
        Rim = Hre * Xim_n + Him * Xre_n - yhim
        res2 = pnorm2(Rre, Rim)
        tv = spatial_tv_norm(Xn, group)
        G_t = d / theta - tv
        G_s = res2 / (2.0 * sigma2 ** 2) - d / (2.0 * sigma2)
        G_p = {}
        for n in free_names:
            dre, dim_ = dHs[n]
            G_p[n] = pdot(dre * Xre_n - dim_ * Xim_n, dre * Xim_n + dim_ * Xre_n,
                          Rre, Rim) / sigma2
        zero = torch.zeros_like(G_t)
        delta_i = d_scale * float(ii) ** (-sapg.d_exp) / d
        theta_n = theta_spec.clip(theta + theta_spec.step_scale * delta_i * G_t)
        params_n = {}
        for s in psf_specs:
            cand = as_t(s.true_value) if s.fix else \
                params[s.name] + s.sign * s.step_scale * delta_i * G_p[s.name]
            params_n[s.name] = s.clip(cand)
        if sigma_fix:
            sigma_n = sigma0
        else:
            sigma_n = torch.clamp(sigma2 + cfg.sigma_step_scale * delta_i * G_s, s2_lo, s2_hi)
        trace = dict(theta=theta_n, sigma2=sigma_n, logPi=-res2 / (2.0 * sigma2) - theta * tv,
                     gX=tv, G_t=G_t, G_s=G_s,
                     **{f"G_{n}": G_p.get(n, zero) for n in psf_names},
                     **{n: params_n[n] for n in psf_names})
        return (Xn, Xre_n, Xim_n, proxn, theta_n, sigma_n, params_n), trace

    keys = _trace_keys(psf_names)

    def scan_seg(carry, iis):
        iis = list(iis)
        buf = torch.empty((len(keys), len(iis)), dtype=dtype, device=device)
        for t, ii in enumerate(iis):
            carry, tr = step(carry, ii)
            buf[:, t] = torch.stack([tr[k] for k in keys])
        host = buf.cpu().numpy()
        return carry, {k: host[i] for i, k in enumerate(keys)}

    pre = f"rank{dist.get_rank() if dist.is_initialized() else 0}/"
    logpi = {}

    def save(carry, done, segs):
        Xl, Xre, Xim, prox, theta, sigma2, params = carry
        arrays = {f"trace/{k}": v for k, v in _merge_traces(segs).items()}
        arrays.update(X=_host(Xl), Xre=_host(Xre), Xim=_host(Xim), prox=_host(prox),
                      theta=_host(theta), sigma2=_host(sigma2), done_iters=np.asarray(done),
                      logpi_wu=_host(logpi["wu"]), logpi0=_host(logpi["0"]))
        if generator is not None:
            arrays["generator_state"] = generator.get_state().numpy()
        for k, v in params.items():
            arrays[f"param/{k}"] = _host(v)
        save_checkpoint_arrays(checkpoint_path, {pre + k: v for k, v in arrays.items()},
                               backend=checkpoint_backend)

    def restore():
        z = {k[len(pre):]: v for k, v in load_checkpoint_arrays(
            checkpoint_path, backend=checkpoint_backend, prefix=pre).items()}
        params = {k[len("param/"):]: as_t(z[k]) for k in z if k.startswith("param/")}
        if generator is not None and "generator_state" in z:
            generator.set_state(torch.from_numpy(z["generator_state"]))
        logpi["wu"], logpi["0"] = as_t(z["logpi_wu"]), as_t(z["logpi0"])
        carry = (as_t(z["X"]), as_t(z["Xre"]), as_t(z["Xim"]), as_t(z["prox"]),
                 as_t(z["theta"]), as_t(z["sigma2"]), params)
        traces = {k[len("trace/"):]: z[k] for k in z if k.startswith("trace/")}
        return carry, int(z["done_iters"]), [traces]

    t0 = time.perf_counter()
    carry = None
    if not (checkpoint_path is not None and os.path.exists(checkpoint_path)):
        carry, logpi["wu"], logpi["0"] = warm_all()
    carry, seg_traces = run_segmented_scan(
        scan_seg, carry, sapg.samples, checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path, save_fn=save, restore_fn=restore,
        fault_hook=fault_hook, nan_guard=nan_guard, max_restores=max_restores,
    )
    X_last = unshard_rows(carry[0], group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    exec_time = time.perf_counter() - t0
    return assemble_result(
        problem, psf_names, _merge_traces(seg_traces) if seg_traces else {},
        _host(logpi["wu"]) if n_warm > 0 else np.zeros(0), float(logpi["0"]),
        _host(X_last)[None], {}, exec_time,
    )
