"""Chambolle TV prox on the card: kernel A of `csrc/tv_kernels.cu`.

Replaces `semiblind_tv_tpu/ops/tv_pallas.py::chambolle_prox_pallas` — both
its warm form (`_kernel`, duals in and out: SALSA's prox, SALSA_v2.m:429)
and its fresh form (`_kernel_fresh`, zero duals, f only: the initial SAPG
prox and the SAPG prox when the fused step is off).  The TPU kernel runs
`dual_ascent_loop`/`neumann_div` with the image resident in VMEM; on Hopper
a 512² field does not fit one SM, so each sweep is one launch over tiles,
with a per-chain device-side `active` flag and fixed-order partial sums for
the early exit (see the source's header).  Bound at 512²: launch latency and
L2 traffic of about five fields a sweep.

`chambolle_prox_cuda` takes the plain version (`chambolle_prox_plain`, a
composition of ops/tv.py) for a CPU tensor and the kernel for a CUDA
tensor; anything else raises.  There is no fallback from the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import ChambolleState, chambolle_prox, divergence

__all__ = [
    "chambolle_prox_cuda", "chambolle_prox_plain", "dual_ascent_loop",
    "neumann_div", "LAUNCHES", "FRESH_LAUNCHES", "TILE_X", "TILE_Y",
]

# Tile geometry of the kernels (csrc/tv_kernels.cu: TX, TY); the CPU test of
# the launch schedule uses it to form the same per-tile partial sums.
TILE_X = 32
TILE_Y = 8

LAUNCHES = 0         # kernel-A launches (both forms) made by chambolle_prox_cuda
FRESH_LAUNCHES = 0   # of which in the fresh (zero-dual) form


def neumann_div(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Plain version of tv_pallas.neumann_div (last row −p1[M−1])."""
    return divergence(p1, p2)


def dual_ascent_loop(glam, tau, tol, max_iter: int, px0, py0):
    """Plain version of tv_pallas.dual_ascent_loop on a chain batch:
    `max_iter` sweeps on g/λ with per-chain early exit on the pre-update
    residual.  Returns (px, py, sweeps_run (int32), last_residual)."""
    _, st = chambolle_prox(glam, 1.0, max_iter, tau=tau, tol=tol, duals=(px0, py0))
    return st.px, st.py, st.iters, st.err


def chambolle_prox_plain(
    g: torch.Tensor,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_state: bool = True,
) -> Tuple[torch.Tensor, ChambolleState]:
    """The plain PyTorch version of the kernel (same signature)."""
    if not return_state and duals is not None:
        raise ValueError("return_state=False requires duals=None (fresh duals)")
    f, st = chambolle_prox(g, lam, max_iter, tau=tau, tol=tol, duals=duals)
    if not return_state:
        zero = torch.zeros_like(f)
        st = ChambolleState(px=zero, py=zero, iters=st.iters, err=st.err)
    return f, st


def scalar_on(value, like: torch.Tensor, name: str) -> torch.Tensor:
    """A 0-d f32 tensor on `like`'s device for a kernel's scalar pointer.
    A Python number becomes a fill launch (no host-to-device copy)."""
    if torch.is_tensor(value):
        if value.device != like.device or value.dtype != torch.float32 or value.numel() != 1:
            raise ValueError(
                f"{name} must be a one-element float32 tensor on {like.device}, "
                f"got {value.dtype} {tuple(value.shape)} on {value.device}"
            )
        return value.reshape(()).contiguous()
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def check_fields(names, tensors, like: torch.Tensor) -> None:
    """Raise unless every field is a contiguous float32 tensor shaped and
    placed like `like` (the kernels take raw pointers)."""
    for name, t in zip(names, tensors):
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, expected {like.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
        if t.shape != like.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(like.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if like.shape[-1] < 2 or like.shape[-2] < 2:
        raise ValueError(f"images must be at least 2x2, got {tuple(like.shape[-2:])}")


def check_status(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def chambolle_prox_cuda(
    g: torch.Tensor,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_state: bool = True,
) -> Tuple[torch.Tensor, ChambolleState]:
    """prox_{λ TV}(g) by Chambolle dual ascent; (M, N) or (B, M, N).

    Signature of tv_pallas.chambolle_prox_pallas without `interpret`.
    return_state=False (fresh duals only) returns zero px/py, as the JAX
    kernel does.  λ may be a Python number or a one-element device tensor."""
    global LAUNCHES, FRESH_LAUNCHES
    if g.device.type == "cpu":
        return chambolle_prox_plain(g, lam, max_iter, tau, tol, duals, return_state)
    if g.device.type != "cuda":
        raise ValueError(f"chambolle_prox_cuda: unsupported device {g.device}")
    if not return_state and duals is not None:
        raise ValueError("return_state=False requires duals=None (fresh duals)")
    from semiblind_tv_tpu_torch._build import load_library

    squeeze = g.ndim == 2
    if squeeze:
        g = g[None]
        if duals is not None:
            duals = (duals[0][None], duals[1][None])
    if g.ndim != 3:
        raise ValueError(f"g must be (M, N) or (B, M, N), got {tuple(g.shape)}")
    names, fields = ["g"], [g]
    if duals is not None:
        names += ["px", "py"]
        fields += list(duals)
    check_fields(names, fields, g)
    lib = load_library()
    B, M, N = g.shape
    with torch.cuda.device(g.device):
        lam_t = scalar_on(lam, g, "lam")
        dev = g.device
        px_buf = torch.empty((2, B, M, N), dtype=torch.float32, device=dev)
        py_buf = torch.empty_like(px_buf)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        err = torch.empty((B,), dtype=torch.float32, device=dev)
        active = torch.empty((B,), dtype=torch.int32, device=dev)
        partials = torch.empty((B, lib.sb_num_tiles(M, N)), dtype=torch.float32, device=dev)
        f = torch.empty_like(g)
        px = torch.empty_like(g) if return_state else None
        py = torch.empty_like(g) if return_state else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sb_chambolle_prox(
            g.data_ptr(), lam_t.data_ptr(),
            duals[0].data_ptr() if duals is not None else None,
            duals[1].data_ptr() if duals is not None else None,
            px_buf.data_ptr(), py_buf.data_ptr(), iters.data_ptr(), err.data_ptr(),
            active.data_ptr(), partials.data_ptr(), f.data_ptr(),
            px.data_ptr() if px is not None else None,
            py.data_ptr() if py is not None else None,
            B, M, N, int(max_iter), float(tau), float(tol), stream,
        )
    check_status(code, "chambolle_prox_cuda")
    LAUNCHES += 1
    if duals is None:
        FRESH_LAUNCHES += 1
    if px is None:
        px = py = torch.zeros_like(f)
    if squeeze:
        f, px, py, iters, err = f[0], px[0], py[0], iters[0], err[0]
    return f, ChambolleState(px=px, py=py, iters=iters, err=err)
