"""The spatial segment of the SAPG step on the card: kernel B of
`csrc/tv_kernels.cu` up to 512², the blocked kernel of `csrc/tv_blocked.cu`
above.

Replaces `semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv`
(`_kernel`), which computes in one VMEM-resident launch per chain batch

    xn    = [abs](x + γ(prox−x)/λ − γ·gradF + √(2γ)·Z)      MYULA update
    proxn = xn − λθ·div p   after n_sweeps fresh Chambolle sweeps on xn/(λθ)
    tv    = Σ √((xn − roll_col xn)² + (xn − roll_row xn)²)  circular TV norm

On Hopper the image does not fit one SM's shared memory, so the segment is
a short launch sequence on one stream with no host sync: a prologue that
writes xn and per-tile TV partials (one fixed-order reduce gives tv[b]),
then kernel A's sweep/reduce pair n_sweeps times on xn/(λθ), then the
assembly of proxn.  Bound at 512²: launch latency and L2 traffic, as
kernel A.  γ, λ and λθ are read from device memory, so the SA loop never
copies them to the host.

Above 512², `myula_prox_tv_blocked` replaces
`fused_step_pallas.py::myula_prox_tv_tiled` (kernel G, 1024²) and
`myula_prox_tv_streamed` (kernel I, ≥2048², which divides gradF by σ² in
its prologue): the same prologue with σ², then the temporally-blocked prox
of ops/tv_blocked_cuda.py on xn/(λθ) from zero duals, then the assembly of
proxn.  G's form passes the divided gradient and σ² = 1 (x / 1 is exact).

`myula_prox_tv` and `myula_prox_tv_blocked` take their plain versions
(`myula_prox_tv_plain`, `myula_prox_tv_blocked_plain`) for a CPU tensor and
the kernel for a CUDA tensor; anything else raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import chambolle_prox, tv_norm
from semiblind_tv_tpu_torch.ops.tv_blocked_cuda import check_geometry, blocked_geometry
from semiblind_tv_tpu_torch.ops.tv_cuda import check_fields, check_status, scalar_on
from semiblind_tv_tpu_torch.samplers.myula import myula_kernel_step

__all__ = [
    "myula_prox_tv", "myula_prox_tv_plain", "myula_prox_tv_blocked",
    "myula_prox_tv_blocked_plain", "LAUNCHES", "BLOCKED_LAUNCHES",
]

LAUNCHES = 0          # kernel-B launches made by myula_prox_tv
BLOCKED_LAUNCHES = 0  # blocked-kernel launches made by myula_prox_tv_blocked


def myula_prox_tv_plain(
    x, prox_cache, grad_f, z, gamma, lam, lam_theta,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the JAX package's unfused path
    (myula_kernel_step → chambolle_prox from fresh duals → tv_norm)."""
    xn = myula_kernel_step(x, prox_cache, grad_f, gamma, lam, z, positivity)
    proxn, _ = chambolle_prox(xn, lam_theta, n_sweeps, tau=tau, tol=tol)
    return xn, proxn, tv_norm(xn)


def myula_prox_tv(
    x: torch.Tensor,
    prox_cache: torch.Tensor,
    grad_f: torch.Tensor,
    z: torch.Tensor,
    gamma,
    lam,
    lam_theta,
    n_sweeps: int = 25,
    tau: float = 0.249,
    tol: float = 1e-3,
    positivity: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_new, prox_new, tv(x_new)); (M, N) or (B, M, N) fields
    (tv is then shape (B,)).  Signature of fused_step_pallas.myula_prox_tv
    without `interpret`."""
    global LAUNCHES
    if x.device.type == "cpu":
        return myula_prox_tv_plain(
            x, prox_cache, grad_f, z, gamma, lam, lam_theta, n_sweeps, tau, tol, positivity
        )
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv: unsupported device {x.device}")
    from semiblind_tv_tpu_torch._build import load_library

    squeeze = x.ndim == 2
    if squeeze:
        x, prox_cache, grad_f, z = x[None], prox_cache[None], grad_f[None], z[None]
    if x.ndim != 3:
        raise ValueError(f"x must be (M, N) or (B, M, N), got {tuple(x.shape)}")
    check_fields(["x", "prox_cache", "grad_f", "z"], [x, prox_cache, grad_f, z], x)
    lib = load_library()
    B, M, N = x.shape
    with torch.cuda.device(x.device):
        scal = [scalar_on(v, x, n) for v, n in
                ((gamma, "gamma"), (lam, "lam"), (lam_theta, "lam_theta"))]
        dev = x.device
        xn = torch.empty_like(x)
        proxn = torch.empty_like(x)
        tv = torch.empty((B,), dtype=torch.float32, device=dev)
        px_buf = torch.empty((2, B, M, N), dtype=torch.float32, device=dev)
        py_buf = torch.empty_like(px_buf)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        err = torch.empty((B,), dtype=torch.float32, device=dev)
        active = torch.empty((B,), dtype=torch.int32, device=dev)
        partials = torch.empty((B, lib.sb_num_tiles(M, N)), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sb_myula_prox_tv(
            x.data_ptr(), prox_cache.data_ptr(), grad_f.data_ptr(), z.data_ptr(),
            *(s.data_ptr() for s in scal),
            xn.data_ptr(), proxn.data_ptr(), tv.data_ptr(),
            px_buf.data_ptr(), py_buf.data_ptr(), iters.data_ptr(), err.data_ptr(),
            active.data_ptr(), partials.data_ptr(),
            B, M, N, int(n_sweeps), float(tau), float(tol), int(bool(positivity)), stream,
        )
    check_status(code, "myula_prox_tv")
    LAUNCHES += 1
    if squeeze:
        xn, proxn, tv = xn[0], proxn[0], tv[0]
    return xn, proxn, tv


def myula_prox_tv_blocked_plain(
    x, prox_cache, grad_f, z, gamma, lam, lam_theta, sigma2=1.0,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: myula_kernel_step with gradF = grad_f/σ²,
    chambolle_prox from fresh duals, tv_norm."""
    return myula_prox_tv_plain(
        x, prox_cache, grad_f / sigma2, z, gamma, lam, lam_theta, n_sweeps, tau, tol, positivity
    )


def myula_prox_tv_blocked(
    x: torch.Tensor,
    prox_cache: torch.Tensor,
    grad_f: torch.Tensor,
    z: torch.Tensor,
    gamma,
    lam,
    lam_theta,
    sigma2=1.0,
    n_sweeps: int = 25,
    tau: float = 0.249,
    tol: float = 1e-3,
    positivity: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_new, prox_new, tv(x_new)) with the MYULA gradient
    grad_f/σ²; (M, N) or (B, M, N) fields.  Signature of
    fused_step_pallas.myula_prox_tv_streamed without the TPU options; σ² = 1
    is myula_prox_tv_tiled's form."""
    global BLOCKED_LAUNCHES
    if x.device.type == "cpu":
        return myula_prox_tv_blocked_plain(
            x, prox_cache, grad_f, z, gamma, lam, lam_theta, sigma2, n_sweeps, tau, tol,
            positivity,
        )
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv_blocked: unsupported device {x.device}")
    from semiblind_tv_tpu_torch._build import load_library

    squeeze = x.ndim == 2
    if squeeze:
        x, prox_cache, grad_f, z = x[None], prox_cache[None], grad_f[None], z[None]
    if x.ndim != 3:
        raise ValueError(f"x must be (M, N) or (B, M, N), got {tuple(x.shape)}")
    check_fields(["x", "prox_cache", "grad_f", "z"], [x, prox_cache, grad_f, z], x)
    B, M, N = x.shape
    TYb, TXb, K = check_geometry(blocked_geometry(M, N), M, N)
    lib = load_library()
    n_part = max(B * K * -(-M // TYb) * -(-N // TXb), B * lib.sb_num_tiles(M, N))
    with torch.cuda.device(x.device):
        scal = [scalar_on(v, x, n) for v, n in
                ((gamma, "gamma"), (lam, "lam"), (lam_theta, "lam_theta"), (sigma2, "sigma2"))]
        dev = x.device
        xn = torch.empty_like(x)
        proxn = torch.empty_like(x)
        tv = torch.empty((B,), dtype=torch.float32, device=dev)
        px_buf = torch.empty((2, B, M, N), dtype=torch.float32, device=dev)
        py_buf = torch.empty_like(px_buf)
        state = torch.empty((B, 6), dtype=torch.int32, device=dev)
        err = torch.empty((B,), dtype=torch.float32, device=dev)
        partials = torch.empty((n_part,), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sb_myula_prox_tv_blocked(
            x.data_ptr(), prox_cache.data_ptr(), grad_f.data_ptr(), z.data_ptr(),
            *(s.data_ptr() for s in scal),
            xn.data_ptr(), proxn.data_ptr(), tv.data_ptr(),
            px_buf.data_ptr(), py_buf.data_ptr(), state.data_ptr(), err.data_ptr(),
            partials.data_ptr(),
            B, M, N, TYb, TXb, K, int(n_sweeps), float(tau), float(tol),
            int(bool(positivity)), stream,
        )
    check_status(code, "myula_prox_tv_blocked")
    BLOCKED_LAUNCHES += 1
    if squeeze:
        xn, proxn, tv = xn[0], proxn[0], tv[0]
    return xn, proxn, tv
