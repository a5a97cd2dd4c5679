"""The spatial segment of the SAPG step on the card: kernel B (and its
in-kernel-noise form C) of `csrc/tv_kernels.cu` up to 512², the blocked
kernel of `csrc/tv_blocked.cu` above.

Replaces `semiblind_tv_tpu/ops/fused_step_pallas.py::myula_prox_tv`
(`_kernel`), which computes in one VMEM-resident launch per chain batch

    xn    = [abs](x + γ(prox−x)/λ − γ·gradF + √(2γ)·Z)      MYULA update
    proxn = xn − λθ·div p   after n_sweeps fresh Chambolle sweeps on xn/(λθ)
    tv    = Σ √((xn − roll_col xn)² + (xn − roll_row xn)²)  circular TV norm

On Hopper the image does not fit one SM's shared memory, so the segment is
kernel A's persistent launch (ops/tv_cuda.py) with a prologue: each tile's
block computes xn of its tile (and of the row and column around it, again
from the inputs), writes xn, and keeps xn/(λθ) in registers; the TV
partials ride on the chain's first barrier; then the sweeps and the
assembly of proxn, all in one launch.  γ, λ and λθ are read from device
memory, so the SA loop never copies them to the host; each is one value
for every chain or one a chain (a (B,) tensor: the problems of a sharded
run, tv_cuda.scalar_on), as the JAX kernel's batching rule gives it.
`myula_prox_tv_emulated` replays the launch's sums (the TV's and the
residuals', in the kernel's order) on the CPU.

Above 512², `myula_prox_tv_blocked` replaces
`fused_step_pallas.py::myula_prox_tv_tiled` (kernel G, 1024²) and
`myula_prox_tv_streamed` (kernel I, ≥2048², which divides gradF by σ² in
its prologue): the same prologue with σ², then the temporally-blocked prox
of ops/tv_blocked_cuda.py on xn/(λθ) from zero duals (its pass split and
halo from `blocked_geometry(n_sweeps)`), then the assembly of proxn.  G's
form passes the divided gradient and σ² = 1 (x / 1 is exact).

`myula_prox_tv_rng` replaces `fused_step_pallas.py::myula_prox_tv_rng`
(kernel C, `_kernel_rng`): kernel B whose prologue draws the noise of chain
b from its seed pair seeds[b] — the Philox/Box–Muller stream of
`ops/rng.py::philox_normals`, evaluated in the kernel at each pixel and at
the tile halo the prologue recomputes for the TV — instead of reading a z
field.
`myula_prox_tv_blocked(..., z=None, seeds=...)` is the same for kernel I's
seeds form (`myula_prox_tv_streamed(z=None, seeds=...)`).  Every pixel's
noise is a pure function of (seed, pixel), so the kernel equals its plain
version fed `philox_normals(seeds)`.

Entry points and their launch counters (profiling.counters):
`myula_prox_tv` (B, `launches.B`), `myula_prox_tv_rng` (C, `launches.C`),
each with `groups.B`/`groups.C`, the chain groups its launches ran one
after another (tv_cuda.resident_geometry),
`myula_prox_tv_blocked` (G and I, `launches.blocked_step`;
`launches.blocked_step.seeds` of them in I's seeds form).  Each takes its
plain version (`*_plain`) for a CPU tensor and the kernel for a CUDA tensor;
anything else raises.  While the recorder is on, each (and each plain
version) hands the prox's per-chain sweep counts to
profiling.count_sweeps under its kernel's letter (B, C, G or I).
"""
from __future__ import annotations

from typing import Tuple

import torch

from semiblind_tv_tpu_torch.ops.rng import philox_normals
from semiblind_tv_tpu_torch.ops.tv import chambolle_prox, tv_norm
from semiblind_tv_tpu_torch.ops.tv_blocked_cuda import (
    STATE_COLS,
    blocked_geometry,
    blocked_kernel,
    check_geometry,
)
from semiblind_tv_tpu_torch.ops.tv_cuda import (
    chain_scalars,
    chain_total,
    chambolle_prox_resident_emulated,
    check_fields,
    check_status,
    per_chain,
    resident_launch,
    tile_sums,
)
from semiblind_tv_tpu_torch.runtime import profiling
from semiblind_tv_tpu_torch.samplers.myula import myula_kernel_step

__all__ = [
    "myula_prox_tv", "myula_prox_tv_plain", "myula_prox_tv_rng", "myula_prox_tv_rng_plain",
    "myula_prox_tv_blocked", "myula_prox_tv_blocked_plain", "myula_prox_tv_emulated",
]


def check_seeds(seeds: torch.Tensor, like: torch.Tensor) -> None:
    """Raise unless seeds is a contiguous (B, 2) int32 tensor on like's device."""
    if seeds.device != like.device:
        raise ValueError(f"seeds is on {seeds.device}, expected {like.device}")
    if seeds.dtype != torch.int32:
        raise TypeError(f"seeds must be int32, got {seeds.dtype}")
    if tuple(seeds.shape) != (like.shape[0], 2) or not seeds.is_contiguous():
        raise ValueError(f"seeds must be a contiguous ({like.shape[0]}, 2) tensor, "
                         f"got {tuple(seeds.shape)}")


def myula_prox_tv_plain(
    x, prox_cache, grad_f, z, gamma, lam, lam_theta,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the JAX package's unfused path
    (myula_kernel_step → chambolle_prox from fresh duals → tv_norm); a
    scalar of one value a chain broadcasts over its chain."""
    return _step_plain("B", x, prox_cache, grad_f, z, gamma, lam, lam_theta, n_sweeps, tau, tol,
                       positivity)


def _step_plain(kernel, x, prox_cache, grad_f, z, gamma, lam, lam_theta, n_sweeps, tau, tol,
                positivity):
    """myula_prox_tv_plain, its sweeps counted as `kernel`'s."""
    gamma, lam, lam_theta = (per_chain(v, x) for v in (gamma, lam, lam_theta))
    xn = myula_kernel_step(x, prox_cache, grad_f, gamma, lam, z, positivity)
    proxn, st = chambolle_prox(xn, lam_theta, n_sweeps, tau=tau, tol=tol)
    profiling.count_sweeps(kernel, st.iters)
    return xn, proxn, tv_norm(xn)


def myula_prox_tv_emulated(
    x, prox_cache, grad_f, z, gamma, lam, lam_theta,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
    capacity=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B's launch on the CPU, (B, M, N) fields: xn by the plain
    update, its circular TV as the fixed-order sum (chain_total) of the
    tiles' partials (tile_sums) of √(dh² + dv²) (taken on the first barrier,
    which a block's stacked chains share), then the prox's schedule
    (chambolle_prox_resident_emulated, the same groups and stacks) on xn
    with λθ.  Returns (xn, proxn, tv, sweeps run)."""
    xn = myula_kernel_step(x, prox_cache, grad_f, per_chain(gamma, x), per_chain(lam, x), z,
                           positivity)
    dh = xn - torch.roll(xn, 1, dims=-1)
    dv = xn - torch.roll(xn, 1, dims=-2)
    t = torch.sqrt(dh * dh + dv * dv)
    tv = torch.stack([chain_total(tile_sums(tb)) for tb in t])
    proxn, st = chambolle_prox_resident_emulated(xn, lam_theta, n_sweeps, tau, tol,
                                                 return_state=False, capacity=capacity)
    return xn, proxn, tv, st.iters


def _launch_step(x, prox_cache, grad_f, z, seeds, gamma, lam, lam_theta, n_sweeps, tau, tol,
                 positivity, what: str):
    """Check, allocate and launch kernel B (noise z) or C (noise drawn from
    seeds) on the card: csrc/tv_kernels.cu::sb_myula_step with σ² = 1, one
    persistent launch (tv_cuda.resident_launch's geometry and workspace).
    Counts the launch and its chain groups and hands the sweeps it ran to
    the recorder.  Returns (xn, proxn, tv, sweeps run, last residual)."""
    from semiblind_tv_tpu_torch._build import load_library

    squeeze = x.ndim == 2
    if squeeze:
        x, prox_cache, grad_f = x[None], prox_cache[None], grad_f[None]
        z = None if z is None else z[None]
        seeds = None if seeds is None else seeds[None]
    if x.ndim != 3:
        raise ValueError(f"x must be (M, N) or (B, M, N), got {tuple(x.shape)}")
    check_fields(["x", "prox_cache", "grad_f"], [x, prox_cache, grad_f], x)
    if z is not None:
        check_fields(["z"], [z], x)
    else:
        check_seeds(seeds, x)
    lib = load_library()
    B, M, N = x.shape
    with torch.cuda.device(x.device):
        scal, strides = chain_scalars(((gamma, "gamma"), (lam, "lam"), (lam_theta, "lam_theta")),
                                      x)
        geo, ws_int, ws_f, stream = resident_launch(x)
        dev = x.device
        xn = torch.empty_like(x)
        proxn = torch.empty_like(x)
        tv = torch.empty((B,), dtype=torch.float32, device=dev)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        err = torch.empty((B,), dtype=torch.float32, device=dev)
        code = lib.sb_myula_step(
            x.data_ptr(), prox_cache.data_ptr(), grad_f.data_ptr(),
            None if z is None else z.data_ptr(), None if seeds is None else seeds.data_ptr(),
            *(s.data_ptr() for s in scal), None,
            xn.data_ptr(), proxn.data_ptr(), tv.data_ptr(), iters.data_ptr(), err.data_ptr(),
            ws_int.data_ptr(), ws_f.data_ptr(), B, M, N, geo.chains, geo.grid, geo.stack,
            int(n_sweeps), float(tau), float(tol), int(bool(positivity)), strides, stream,
        )
    check_status(code, what)
    kernel = "B" if z is not None else "C"
    profiling.counters.add("launches." + kernel)
    profiling.counters.add("groups." + kernel, geo.groups)
    profiling.count_sweeps(kernel, iters)
    if squeeze:
        xn, proxn, tv, iters, err = xn[0], proxn[0], tv[0], iters[0], err[0]
    return xn, proxn, tv, iters, err


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
    if x.device.type == "cpu":
        return myula_prox_tv_plain(
            x, prox_cache, grad_f, z, gamma, lam, lam_theta, n_sweeps, tau, tol, positivity
        )
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv: unsupported device {x.device}")
    return _launch_step(x, prox_cache, grad_f, z, None, gamma, lam, lam_theta, n_sweeps, tau,
                        tol, positivity, "myula_prox_tv")[:3]


def myula_prox_tv_rng_plain(
    x, prox_cache, grad_f, seeds, gamma, lam, lam_theta,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: myula_prox_tv_plain with the noise
    philox_normals(seeds) in x's type."""
    z = philox_normals(seeds, x.shape[-2:], x.dtype)
    return _step_plain("C", x, prox_cache, grad_f, z, gamma, lam, lam_theta, n_sweeps, tau, tol,
                       positivity)


def myula_prox_tv_rng(
    x: torch.Tensor,
    prox_cache: torch.Tensor,
    grad_f: torch.Tensor,
    seeds: torch.Tensor,
    gamma,
    lam,
    lam_theta,
    n_sweeps: int = 25,
    tau: float = 0.249,
    tol: float = 1e-3,
    positivity: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C: (x_new, prox_new, tv(x_new)) with the noise drawn in the
    kernel from seeds, (B, 2) int32 on x's device ((2,) for an (M, N)
    field).  Signature of fused_step_pallas.myula_prox_tv_rng."""
    if x.device.type == "cpu":
        return myula_prox_tv_rng_plain(
            x, prox_cache, grad_f, seeds, gamma, lam, lam_theta, n_sweeps, tau, tol, positivity
        )
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv_rng: unsupported device {x.device}")
    return _launch_step(x, prox_cache, grad_f, None, seeds, gamma, lam, lam_theta, n_sweeps, tau,
                        tol, positivity, "myula_prox_tv_rng")[:3]


def myula_prox_tv_blocked_plain(
    x, prox_cache, grad_f, z, gamma, lam, lam_theta, sigma2=1.0,
    n_sweeps: int = 25, tau: float = 0.249, tol: float = 1e-3, positivity: bool = True,
    seeds=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: myula_kernel_step with gradF = grad_f/σ²
    and the noise z (or philox_normals(seeds) when z is None),
    chambolle_prox from fresh duals, tv_norm."""
    if z is None:
        z = philox_normals(seeds, x.shape[-2:], x.dtype)
    return _step_plain(blocked_kernel(x.shape[-2:], "G", "I"), x, prox_cache,
                       grad_f / per_chain(sigma2, x), z, gamma, lam, lam_theta, n_sweeps, tau, tol,
                       positivity)


def myula_prox_tv_blocked(
    x: torch.Tensor,
    prox_cache: torch.Tensor,
    grad_f: torch.Tensor,
    z,
    gamma,
    lam,
    lam_theta,
    sigma2=1.0,
    n_sweeps: int = 25,
    tau: float = 0.249,
    tol: float = 1e-3,
    positivity: bool = True,
    seeds=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x_new, prox_new, tv(x_new)) with the MYULA gradient
    grad_f/σ²; (M, N) or (B, M, N) fields.  Signature of
    fused_step_pallas.myula_prox_tv_streamed without the TPU options; σ² = 1
    is myula_prox_tv_tiled's form.  The noise is z, or, with z=None, drawn
    in the kernel from seeds ((B, 2) int32 on x's device): I's seeds form."""
    if (z is None) == (seeds is None):
        raise ValueError("myula_prox_tv_blocked takes exactly one of z and seeds")
    if x.device.type == "cpu":
        return myula_prox_tv_blocked_plain(
            x, prox_cache, grad_f, z, gamma, lam, lam_theta, sigma2, n_sweeps, tau, tol,
            positivity, seeds,
        )
    if x.device.type != "cuda":
        raise ValueError(f"myula_prox_tv_blocked: unsupported device {x.device}")
    from semiblind_tv_tpu_torch._build import load_library

    squeeze = x.ndim == 2
    if squeeze:
        x, prox_cache, grad_f = x[None], prox_cache[None], grad_f[None]
        z = None if z is None else z[None]
        seeds = None if seeds is None else seeds[None]
    if x.ndim != 3:
        raise ValueError(f"x must be (M, N) or (B, M, N), got {tuple(x.shape)}")
    check_fields(["x", "prox_cache", "grad_f"], [x, prox_cache, grad_f], x)
    if z is not None:
        check_fields(["z"], [z], x)
    else:
        check_seeds(seeds, x)
    B, M, N = x.shape
    TYb, TXb, K = check_geometry(blocked_geometry(n_sweeps), M, N, n_sweeps)
    lib = load_library()
    n_part = max(B * K * -(-M // TYb) * -(-N // TXb), B * lib.sb_num_tiles(M, N))
    with torch.cuda.device(x.device):
        scal, strides = chain_scalars(((gamma, "gamma"), (lam, "lam"), (lam_theta, "lam_theta"),
                                       (sigma2, "sigma2")), x)
        dev = x.device
        xn = torch.empty_like(x)
        proxn = torch.empty_like(x)
        tv = torch.empty((B,), dtype=torch.float32, device=dev)
        px_buf = torch.empty((2, B, M, N), dtype=torch.float32, device=dev)
        py_buf = torch.empty_like(px_buf)
        state = torch.empty((B, STATE_COLS), dtype=torch.int32, device=dev)
        err = torch.empty((B,), dtype=torch.float32, device=dev)
        partials = torch.empty((n_part,), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sb_myula_prox_tv_blocked(
            x.data_ptr(), prox_cache.data_ptr(), grad_f.data_ptr(),
            None if z is None else z.data_ptr(), None if seeds is None else seeds.data_ptr(),
            *(s.data_ptr() for s in scal),
            xn.data_ptr(), proxn.data_ptr(), tv.data_ptr(),
            px_buf.data_ptr(), py_buf.data_ptr(), state.data_ptr(), err.data_ptr(),
            partials.data_ptr(),
            B, M, N, TYb, TXb, K, int(n_sweeps), float(tau), float(tol),
            int(bool(positivity)), strides, stream,
        )
    check_status(code, "myula_prox_tv_blocked")
    profiling.counters.add("launches.blocked_step")
    if seeds is not None:
        profiling.counters.add("launches.blocked_step.seeds")
    profiling.count_sweeps(blocked_kernel((M, N), "G", "I"), state[:, 0])
    if squeeze:
        xn, proxn, tv = xn[0], proxn[0], tv[0]
    return xn, proxn, tv
