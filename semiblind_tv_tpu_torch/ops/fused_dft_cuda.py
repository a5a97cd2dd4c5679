"""The whole-iteration DFT steps on the card: kernels D and E of
`csrc/dft_kernels.cu`.

Replaces `semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv_dft`
(kernel D, `_kernel_dft`) and `myula_prox_tv_irdft` (kernel E,
`_kernel_irdft`), which run one VMEM-resident launch per chain:

    grad  = irfft2(Ĝ) by six DFT matmuls            (Ĝ = conj(H)·R̂)
    xn, proxn, tv = kernel B's step with gradF = grad/σ²
    x̂     = rfft2(xn) by six DFT matmuls           (D only)

On Hopper the (M, M) factor matrices alone exceed one SM's shared memory,
so each is a short launch sequence on one stream with no host sync: two
GEMM launches for the inverse transform, kernel B's sequence with σ²
(csrc/tv_kernels.cu), and for D two more GEMM launches for the forward
transform, which write x̂ straight into the complex output.  The GEMM is
the port's own fp32 kernel (no TF32, no cuBLAS); the factor matrices are
`ops/fourier.py::rdft_matrices` in float32 on the card.

`myula_prox_tv_dft` and `myula_prox_tv_irdft` take their plain versions
(`*_plain`: the JAX kernels' bodies on `torch.matmul`) for a CPU tensor and
the kernel for a CUDA tensor; anything else raises.  With
return_iters=True each also returns the prox's per-chain sweep counts
(int32), which the JAX kernels keep to themselves.  Launch counters:
DFT_LAUNCHES (D), IRDFT_LAUNCHES (E).
"""
from __future__ import annotations

from typing import Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import chambolle_prox, tv_norm
from semiblind_tv_tpu_torch.ops.tv_cuda import check_fields, check_status, scalar_on
from semiblind_tv_tpu_torch.samplers.myula import myula_kernel_step

__all__ = [
    "myula_prox_tv_dft", "myula_prox_tv_dft_plain", "myula_prox_tv_irdft",
    "myula_prox_tv_irdft_plain", "DFT_LAUNCHES", "IRDFT_LAUNCHES",
]

DFT_LAUNCHES = 0     # kernel-D launches made by myula_prox_tv_dft
IRDFT_LAUNCHES = 0   # kernel-E launches made by myula_prox_tv_irdft

_INVERSE = ("CM", "SM", "WCT", "WST")
_FORWARD = ("CN", "SN")


def _grad_plain(ghat, mats, sigma2):
    """irfft2(Ĝ)/σ² in the operation order of _kernel_dft: the inverse
    columns scaled by the value of 1/M, then the inverse rows."""
    cm, sm = mats["CM"], mats["SM"]
    zre, zim = ghat.real, ghat.imag
    inv_m = 1.0 / cm.shape[0]
    yre = (torch.matmul(cm, zre) - torch.matmul(sm, zim)) * inv_m
    yim = (torch.matmul(cm, zim) + torch.matmul(sm, zre)) * inv_m
    return (torch.matmul(yre, mats["WCT"]) - torch.matmul(yim, mats["WST"])) / sigma2


def myula_prox_tv_irdft_plain(
    ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
    return_iters: bool = False,
):
    """The plain PyTorch version of kernel E (the body of _kernel_irdft)."""
    grad = _grad_plain(ghat, rdft_mats, sigma2)
    xn = myula_kernel_step(x, prox_cache, grad, gamma, lam, z, positivity)
    proxn, st = chambolle_prox(xn, lam_theta, n_sweeps, tau=tau, tol=tol)
    out = (xn, proxn, tv_norm(xn))
    return out + (st.iters,) if return_iters else out


def myula_prox_tv_dft_plain(
    ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
    return_iters: bool = False,
):
    """The plain PyTorch version of kernel D (the body of _kernel_dft)."""
    xn, proxn, tv, iters = myula_prox_tv_irdft_plain(
        ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2, n_sweeps, tau, tol,
        positivity, return_iters=True)
    cm, sm = rdft_mats["CM"], rdft_mats["SM"]
    fre = torch.matmul(xn, rdft_mats["CN"])
    fim = -torch.matmul(xn, rdft_mats["SN"])
    xhat = torch.complex(torch.matmul(cm, fre) + torch.matmul(sm, fim),
                         torch.matmul(cm, fim) - torch.matmul(sm, fre))
    out = (xn, proxn, tv, xhat)
    return out + (iters,) if return_iters else out


def _launch(ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2, n_sweeps, tau,
            tol, positivity, forward: bool, return_iters: bool):
    """Check, allocate and launch D (forward=True) or E on the card."""
    from semiblind_tv_tpu_torch._build import load_library

    what = "myula_prox_tv_dft" if forward else "myula_prox_tv_irdft"
    squeeze = x.ndim == 2
    if squeeze:
        ghat, x, prox_cache, z = ghat[None], x[None], prox_cache[None], z[None]
    if x.ndim != 3:
        raise ValueError(f"x must be (M, N) or (B, M, N), got {tuple(x.shape)}")
    check_fields(["x", "prox_cache", "z"], [x, prox_cache, z], x)
    B, M, N = x.shape
    Nh = N // 2 + 1
    if ghat.dtype != torch.complex64 or tuple(ghat.shape) != (B, M, Nh) \
            or not ghat.is_contiguous() or ghat.device != x.device:
        raise ValueError(f"{what}: ghat must be a contiguous complex64 ({B}, {M}, {Nh}) "
                         f"tensor on {x.device}, got {ghat.dtype} {tuple(ghat.shape)}")
    names = _INVERSE + (_FORWARD if forward else ())
    mats = [rdft_mats[k] for k in names]
    shapes = dict(CM=(M, M), SM=(M, M), WCT=(Nh, N), WST=(Nh, N), CN=(N, Nh), SN=(N, Nh))
    for k, m in zip(names, mats):
        if m.device != x.device or m.dtype != torch.float32 or tuple(m.shape) != shapes[k] \
                or not m.is_contiguous():
            raise ValueError(f"{what}: rdft_mats[{k!r}] must be a contiguous float32 "
                             f"{shapes[k]} tensor on {x.device}")
    lib = load_library()
    with torch.cuda.device(x.device):
        scal = [scalar_on(v, x, n) for v, n in ((gamma, "gamma"), (lam, "lam"),
                                                (lam_theta, "lam_theta"), (sigma2, "sigma2"))]
        dev = x.device
        f32 = dict(dtype=torch.float32, device=dev)
        xn = torch.empty_like(x)
        proxn = torch.empty_like(x)
        tv = torch.empty((B,), **f32)
        ybuf = torch.empty((B, 2 * M, Nh), **f32)
        grad = torch.empty((B, M, N), **f32)
        px_buf = torch.empty((2, B, M, N), **f32)
        py_buf = torch.empty_like(px_buf)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        err = torch.empty((B,), **f32)
        active = torch.empty((B,), dtype=torch.int32, device=dev)
        partials = torch.empty((B, lib.sb_num_tiles(M, N)), **f32)
        ghat_f = torch.view_as_real(ghat)
        stream = torch.cuda.current_stream(dev).cuda_stream
        tail = (px_buf.data_ptr(), py_buf.data_ptr(), iters.data_ptr(), err.data_ptr(),
                active.data_ptr(), partials.data_ptr(), B, M, N, int(n_sweeps), float(tau),
                float(tol), int(bool(positivity)), stream)
        head = (ghat_f.data_ptr(), x.data_ptr(), prox_cache.data_ptr(), z.data_ptr(),
                *(m.data_ptr() for m in mats), *(s.data_ptr() for s in scal),
                xn.data_ptr(), proxn.data_ptr(), tv.data_ptr())
        if forward:
            xhat = torch.empty((B, M, Nh), dtype=torch.complex64, device=dev)
            fbuf = torch.empty((B, M, 2 * Nh), **f32)
            code = lib.sb_myula_prox_tv_dft(
                *head, torch.view_as_real(xhat).data_ptr(), ybuf.data_ptr(), grad.data_ptr(),
                fbuf.data_ptr(), *tail)
            out = (xn, proxn, tv, xhat)
        else:
            code = lib.sb_myula_prox_tv_irdft(*head, ybuf.data_ptr(), grad.data_ptr(), *tail)
            out = (xn, proxn, tv)
    check_status(code, what)
    if return_iters:
        out = out + (iters,)
    return tuple(o[0] for o in out) if squeeze else out


def myula_prox_tv_dft(
    ghat: torch.Tensor,
    x: torch.Tensor,
    prox_cache: torch.Tensor,
    z: torch.Tensor,
    rdft_mats,
    gamma,
    lam,
    lam_theta,
    sigma2,
    n_sweeps: int = 25,
    tau: float = 0.249,
    tol: float = 1e-3,
    positivity: bool = True,
    return_iters: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Kernel D: (x_new, prox_new, tv, xhat_new) of one SAPG iteration from
    Ĝ = conj(H)·(H·X̂ − ŷ) (before the σ² division); rdft_mats is
    fourier.rdft_matrices(shape).  Signature of
    fused_step_pallas.myula_prox_tv_dft without `interpret` and
    `precision` (the port's products are full fp32)."""
    global DFT_LAUNCHES
    if x.device.type == "cpu":
        return myula_prox_tv_dft_plain(ghat, x, prox_cache, z, rdft_mats, gamma, lam,
                                       lam_theta, sigma2, n_sweeps, tau, tol, positivity,
                                       return_iters)
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv_dft: unsupported device {x.device}")
    out = _launch(ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2, n_sweeps,
                  tau, tol, positivity, True, return_iters)
    DFT_LAUNCHES += 1
    return out


def myula_prox_tv_irdft(
    ghat: torch.Tensor,
    x: torch.Tensor,
    prox_cache: torch.Tensor,
    z: torch.Tensor,
    rdft_mats,
    gamma,
    lam,
    lam_theta,
    sigma2,
    n_sweeps: int = 25,
    tau: float = 0.249,
    tol: float = 1e-3,
    positivity: bool = True,
    return_iters: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Kernel E: kernel D without the forward transform; returns (x_new,
    prox_new, tv).  Signature of fused_step_pallas.myula_prox_tv_irdft
    without `interpret` and `precision`."""
    global IRDFT_LAUNCHES
    if x.device.type == "cpu":
        return myula_prox_tv_irdft_plain(ghat, x, prox_cache, z, rdft_mats, gamma, lam,
                                         lam_theta, sigma2, n_sweeps, tau, tol, positivity,
                                         return_iters)
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv_irdft: unsupported device {x.device}")
    out = _launch(ghat, x, prox_cache, z, rdft_mats, gamma, lam, lam_theta, sigma2, n_sweeps,
                  tau, tol, positivity, False, return_iters)
    IRDFT_LAUNCHES += 1
    return out
