"""Chambolle TV prox above 512² on the card: the temporally-blocked kernel
of `csrc/tv_blocked.cu`.

Replaces `semiblind_tv_tpu/ops/tv_pallas.py::chambolle_prox_tiled` (kernel
F, 1024²: duals in whole-image VMEM scratch, row tiles) and
`chambolle_prox_streamed` / `streamed_call` modes plain and warm (kernel H,
≥2048²: duals ping-pong in HBM, K sweeps per row window, a mid-pass redo
for an exact early exit).  Both become one Hopper design: 2-D tiles with a
halo of K on every side, up to K sweeps per window with the duals in
registers, duals ping-pong in device memory, per-tile per-sweep residual
partials reduced by the last tile of each chain, and a redo launch (see the
source's header).  SALSA takes the warm form (duals in and out) and the
SAPG's initial prox the fresh form.

`chambolle_prox_blocked` takes the plain version (`chambolle_prox_blocked_plain`,
ops/tv.py::chambolle_prox) for a CPU tensor and the kernel for a CUDA
tensor; anything else raises.  `chambolle_prox_blocked_emulated` replays
the kernel's schedule in PyTorch — the balanced pass split, windows, halos,
per-tile per-sweep partials summed in the kernel's order, the folded reduce
and the redo — so the CPU tests hold that schedule against the whole-image
prox.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import ChambolleState, divergence
from semiblind_tv_tpu_torch.ops.tv_cuda import (
    _tree,
    chambolle_prox_plain,
    check_fields,
    check_status,
    per_chain,
    scalar_on,
)
from semiblind_tv_tpu_torch.runtime import profiling

__all__ = [
    "chambolle_prox_blocked", "chambolle_prox_blocked_plain",
    "chambolle_prox_blocked_emulated", "blocked_geometry", "blocked_rung",
    "check_geometry", "pass_split", "halo_factor", "blocked_kernel",
    "SWEEP_BLOCK",
]

# Constants of csrc/tv_blocked.cu: warps across and down a pass block, rows
# of a thread's strip, most sweeps per pass, int32 state words per chain;
# and of csrc/common.cuh: threads of a per-chain reduce.
WARPS_X = 4
WARPS_Y = 4
STRIP_ROWS = 16
SWEEP_BLOCK = 8
STATE_COLS = 7
REDUCE_THREADS = 256
WINDOW_COLS = 32 * WARPS_X             # 128
WINDOW_ROWS = STRIP_ROWS * WARPS_Y     # 64

# Launch counters (profiling.counters): `launches.blocked_prox`, blocked-prox
# launches (both forms) made by chambolle_prox_blocked; `launches.blocked_prox.fresh`,
# of which in the fresh (zero-dual) form.  Sweep counters: `sweeps.F` (up to
# 1024² pixels) and `sweeps.H` (above), by blocked_kernel.

chambolle_prox_blocked_plain = chambolle_prox_plain  # ops/tv.py::chambolle_prox


def blocked_rung(shape) -> Optional[str]:
    """The TPU rung an (M, N) image is on: None up to 512² (the whole-image
    kernels A and B), 'tiled' up to 1024² pixels (F and G, whose three
    whole-image scratch fields fit 12 MB of VMEM), 'streamed' above (H and
    I).  On the card both rungs run the same blocked kernel family."""
    M, N = shape
    if max(M, N) <= 512:
        return None
    return "tiled" if M * N <= 1024 * 1024 else "streamed"


def blocked_kernel(shape, tiled: str, streamed: str) -> str:
    """The TPU kernel a blocked call on an (M, N) image stands for: `streamed`
    on the streamed rung, `tiled` below it (a forced call at ≤512² too)."""
    return streamed if blocked_rung(shape) == "streamed" else tiled


def pass_split(max_iter: int) -> Tuple[int, ...]:
    """The sweeps of each pass: ⌈max_iter/8⌉ passes of near-equal size, the
    longer ones first (25 → 7, 6, 6, 6; 10 → 5, 5; 0 → none), as the host
    loop of csrc/tv_blocked.cu::prox_blocked issues them."""
    n = -(-max_iter // SWEEP_BLOCK)
    return tuple(max_iter // n + (i < max_iter % n) for i in range(n))


def blocked_geometry(max_iter: int) -> Tuple[int, int, int, Tuple[int, ...]]:
    """(TY, TX, K, split) of the blocked kernel for a budget of max_iter
    sweeps: the Hopper counterpart of tv_pallas.streamed_tile_rows, sized to
    the pass block's 64 × 128 window (4 × 4 warps, 16-row strips, the duals
    in registers: 128 registers a thread and no spills, so one 512-thread
    block an SM, set by registers, not by shared memory; chip_smoke.py
    prints both) instead of to VMEM.

    The halo K is the longest pass of `pass_split(max_iter)` and the
    central tile the window less K on every side: 50 × 114 at K = 7 (25
    sweeps), 54 × 118 at K = 5 (10 sweeps).  Its cost: `halo_factor`,
    1.44× and 1.29× the stencil work of the central pixels, and
    device-memory traffic of about (3 · 1.44 + 2)/6.25 ≈ 1 field a sweep.
    Windows clamp to the image, so any M, N ≥ 2 works; an image smaller
    than a window is one window."""
    split = pass_split(max_iter)
    K = max(split, default=1)
    return WINDOW_ROWS - 2 * K, WINDOW_COLS - 2 * K, K, split


def halo_factor(geometry) -> float:
    """Window pixels swept per central pixel of an unclamped window."""
    TYb, TXb, K = geometry[:3]
    return (TYb + 2 * K) * (TXb + 2 * K) / (TYb * TXb)


def check_geometry(geometry, M, N, max_iter):
    """Raise unless (TY, TX, K) fits the kernel: its window, clamped to the
    image, at most 64 × 128, and 1 ≤ K ≤ 8 at least the longest pass of
    max_iter's split; returns (TY, TX, K)."""
    TYb, TXb, K = geometry[:3]
    wh, ww = min(TYb + 2 * K, M), min(TXb + 2 * K, N)
    if not (max(pass_split(max_iter), default=1) <= K <= SWEEP_BLOCK and TYb >= 1
            and TXb >= 1 and wh <= WINDOW_ROWS and ww <= WINDOW_COLS):
        raise ValueError(f"geometry {tuple(geometry)} does not fit the kernel for "
                         f"{max_iter} sweeps (window {wh}x{ww})")
    return TYb, TXb, K


def chambolle_prox_blocked(
    g: torch.Tensor,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_state: bool = True,
) -> Tuple[torch.Tensor, ChambolleState]:
    """prox_{λ TV}(g) by Chambolle dual ascent, temporally blocked; (M, N)
    or (B, M, N).  Signature of tv_cuda.chambolle_prox_cuda.  duals warm-
    start the ascent (SALSA's 'dualvars', SALSA_v2.m:429); return_state=False
    (fresh duals only) returns zero px/py."""
    if g.device.type == "cpu":
        return chambolle_prox_blocked_plain(g, lam, max_iter, tau, tol, duals, return_state)
    if g.device.type != "cuda":
        raise ValueError(f"chambolle_prox_blocked: unsupported device {g.device}")
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
    B, M, N = g.shape
    TYb, TXb, K = check_geometry(blocked_geometry(max_iter), M, N, max_iter)
    lib = load_library()
    ntiles = -(-M // TYb) * -(-N // TXb)
    with torch.cuda.device(g.device):
        lam_t, strides = scalar_on(lam, g, "lam")
        dev = g.device
        px_buf = torch.empty((2, B, M, N), dtype=torch.float32, device=dev)
        py_buf = torch.empty_like(px_buf)
        state = torch.empty((B, STATE_COLS), dtype=torch.int32, device=dev)
        err = torch.empty((B,), dtype=torch.float32, device=dev)
        partials = torch.empty((B * K * ntiles,), dtype=torch.float32, device=dev)
        f = torch.empty_like(g)
        px = torch.empty_like(g) if return_state else None
        py = torch.empty_like(g) if return_state else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.sb_chambolle_prox_blocked(
            g.data_ptr(), lam_t.data_ptr(),
            duals[0].data_ptr() if duals is not None else None,
            duals[1].data_ptr() if duals is not None else None,
            px_buf.data_ptr(), py_buf.data_ptr(), state.data_ptr(), err.data_ptr(),
            partials.data_ptr(), f.data_ptr(),
            px.data_ptr() if px is not None else None,
            py.data_ptr() if py is not None else None,
            B, M, N, TYb, TXb, K, int(max_iter), float(tau), float(tol), strides, stream,
        )
    check_status(code, "chambolle_prox_blocked")
    profiling.counters.add("launches.blocked_prox")
    if duals is None:
        profiling.counters.add("launches.blocked_prox.fresh")
    profiling.count_sweeps(blocked_kernel((M, N), "F", "H"), state[:, 0])
    if px is None:
        px = py = torch.zeros_like(f)
    iters = state[:, 0].contiguous()
    if squeeze:
        f, px, py, iters, err = f[0], px[0], py[0], iters[0], err[0]
    return f, ChambolleState(px=px, py=py, iters=iters, err=err)


# ---------------------------------------------------------------------------
# The kernel's schedule, replayed in PyTorch
# ---------------------------------------------------------------------------

def _block_sum(r2: torch.Tensor) -> torch.Tensor:
    """blocked_pass's per-tile sum of (T, wh, ww) window values (zero
    outside the central tile): the window padded to the pass block's 64 ×
    128, thread (warp w, lane l) sums the 16 rows of its strip of column
    32·(w mod 4) + l in order, a shuffle tree sums each warp, then the warps
    are added in order w = 0, 1, …"""
    T, wh, ww = r2.shape
    pad = torch.zeros((T, WINDOW_ROWS, WINDOW_COLS), dtype=r2.dtype)
    pad[:, :wh, :ww] = r2
    strips = pad.view(T, WARPS_Y, STRIP_ROWS, WARPS_X, 32)
    acc = strips[:, :, 0]
    for i in range(1, STRIP_ROWS):
        acc = acc + strips[:, :, i]
    warps = _tree(acc).reshape(T, WARPS_Y * WARPS_X)   # warp w = WARPS_X·wy + wx
    s = warps[:, 0]
    for w in range(1, WARPS_Y * WARPS_X):
        s = s + warps[:, w]
    return s


def _chain_sum(partials: torch.Tensor) -> torch.Tensor:
    """common.cuh::chain_sum: thread t sums partials t, t + 256, ... in
    order, then a shared-memory tree."""
    n = partials.shape[0]
    rows = -(-n // REDUCE_THREADS)
    pad = torch.zeros(rows * REDUCE_THREADS, dtype=partials.dtype)
    pad[:n] = partials
    acc = torch.zeros(REDUCE_THREADS, dtype=partials.dtype)
    for i in range(rows):
        acc = acc + pad[i * REDUCE_THREADS:(i + 1) * REDUCE_THREADS]
    return _tree(acc)


def _windows(M, N, TYb, TXb, K):
    """Per tile, in launch order (row-major): window origin and the central
    tile, as blocked_pass computes them."""
    wh, ww = min(TYb + 2 * K, M), min(TXb + 2 * K, N)
    tiles = []
    for y0 in range(0, M, TYb):
        for x0 in range(0, N, TXb):
            h0 = min(max(y0 - K, 0), M - wh)
            w0 = min(max(x0 - K, 0), N - ww)
            tiles.append((h0, w0, y0 - h0, min(y0 + TYb, M) - h0,
                          x0 - w0, min(x0 + TXb, N) - w0))
    return wh, ww, tiles


def _window_u(px, py, glam, bottom, right):
    """u = div p − g/λ on (T, wh, ww) windows: a window's first row/column
    keeps p itself (image row 0, or an edge inside the image whose value is
    never used), the image's last row/column takes −p."""
    a_last = torch.where(bottom, -px[:, -1:], px[:, -1:] - px[:, -2:-1])
    a = torch.cat([px[:, :1], px[:, 1:-1] - px[:, :-2], a_last], dim=1)
    b_last = torch.where(right, -py[:, :, -1:], py[:, :, -1:] - py[:, :, -2:-1])
    b = torch.cat([py[:, :, :1], py[:, :, 1:-1] - py[:, :, :-2], b_last], dim=2)
    return (a + b) - glam


def chambolle_prox_blocked_emulated(
    g: torch.Tensor,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_state: bool = True,
    geometry: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, ChambolleState]:
    """The blocked kernel's launch schedule in PyTorch, on the CPU:
    blocked_init, then for each pass of pass_split(max_iter) blocked_pass
    (every tile of every active chain: clamped window, the pass's sweeps,
    central tile to the other buffer, per-sweep partials in the kernel's
    summation order; then the chain's last tile's reduce: chain_sum's order,
    the first sweep j* with sqrt(sum) ≤ tol, the state update) and the redo
    pass from the intact source with limit j*, then assembly.  geometry =
    (TY, TX, K), by default blocked_geometry's.  Same signature and results
    as chambolle_prox_blocked otherwise."""
    squeeze = g.ndim == 2
    if squeeze:
        g = g[None]
        if duals is not None:
            duals = (duals[0][None], duals[1][None])
    if not return_state and duals is not None:
        raise ValueError("return_state=False requires duals=None (fresh duals)")
    B, M, N = g.shape
    TYb, TXb, K = check_geometry(geometry or blocked_geometry(max_iter), M, N, max_iter)
    lam = per_chain(lam, g)
    lam_b = (lambda b: lam[b]) if torch.is_tensor(lam) and lam.ndim == 3 else (lambda b: lam)
    wh, ww, tiles = _windows(M, N, TYb, TXb, K)
    T = len(tiles)
    rows = torch.tensor([[h0 + r for r in range(wh)] for h0, *_ in tiles])
    cols = torch.tensor([[t[1] + c for c in range(ww)] for t in tiles])
    bottom = torch.tensor([t[0] + wh == M for t in tiles])[:, None, None]
    right = torch.tensor([t[1] + ww == N for t in tiles])[:, None, None]
    rr = torch.arange(wh)[None, :, None]
    cc = torch.arange(ww)[None, None, :]
    lo_r, hi_r, lo_c, hi_c = (torch.tensor([t[i] for t in tiles])[:, None, None]
                              for i in (2, 3, 4, 5))
    central = (rr >= lo_r) & (rr < hi_r) & (cc >= lo_c) & (cc < hi_c)  # (T, wh, ww)

    def gather(field):
        return field[rows[:, :, None], cols[:, None, :]]

    buf = torch.zeros((2, 2, B, M, N), dtype=g.dtype)   # [buffer, px/py]
    iters = [0] * B
    err = torch.full((B,), float("inf"), dtype=g.dtype)
    active = [True] * B
    src = [2] * B
    partials = torch.full((B, K, T), float("nan"), dtype=g.dtype)

    def source(b, s):
        if s == 2:
            if duals is None:
                return torch.zeros((M, N), dtype=g.dtype), torch.zeros((M, N), dtype=g.dtype)
            return duals[0][b], duals[1][b]
        return buf[s, 0, b], buf[s, 1, b]

    def run_pass(b, s_from, s_to, lim, record):
        sx_img, sy_img = source(b, s_from)
        glam = gather(g[b] / lam_b(b))   # elementwise: the same values as per pixel
        px, py = gather(sx_img), gather(sy_img)
        for s in range(lim):
            u = _window_u(px, py, glam, bottom, right)
            zr = torch.zeros_like(u[:, :1])
            zc = torch.zeros_like(u[:, :, :1])
            upx = torch.cat([u[:, 1:] - u[:, :-1], zr], dim=1)
            upy = torch.cat([u[:, :, 1:] - u[:, :, :-1], zc], dim=2)
            tmp = torch.sqrt(upx * upx + upy * upy)
            rx = -upx + tmp * px
            ry = -upy + tmp * py
            r2 = torch.where(central, rx * rx + ry * ry, torch.zeros_like(rx))
            if record:
                partials[b, s] = _block_sum(r2)
            denom = 1.0 + tau * tmp
            px, py = (px + tau * upx) / denom, (py + tau * upy) / denom
        for t, (h0, w0, r0, r1, c0, c1) in enumerate(tiles):
            buf[s_to, 0, b, h0 + r0:h0 + r1, w0 + c0:w0 + c1] = px[t, r0:r1, c0:c1]
            buf[s_to, 1, b, h0 + r0:h0 + r1, w0 + c0:w0 + c1] = py[t, r0:r1, c0:c1]

    for limit in pass_split(max_iter):
        dst = {}
        for b in range(B):                    # blocked_pass
            if active[b]:
                dst[b] = 1 if src[b] == 0 else 0
                run_pass(b, src[b], dst[b], limit, True)
        redo = {}
        for b in dst:                         # the last tile's reduce
            es = [torch.sqrt(_chain_sum(partials[b, j])) for j in range(limit)]
            jstar = next((j + 1 for j, e in enumerate(es) if not bool(e > tol)), 0)
            jstop = jstar if jstar else limit
            iters[b] += jstop
            err[b] = es[jstop - 1]
            active[b] = jstar == 0
            if 0 < jstar < limit:
                redo[b] = (src[b], jstar)
            src[b] = dst[b]
        for b, (prev, jstar) in redo.items():  # redo pass
            run_pass(b, prev, src[b], jstar, False)

    px = torch.stack([source(b, src[b])[0] for b in range(B)])
    py = torch.stack([source(b, src[b])[1] for b in range(B)])
    f = g - lam * divergence(px, py)
    if not return_state:
        px = py = torch.zeros_like(f)
    iters_t = torch.tensor(iters, dtype=torch.int32)
    if squeeze:
        return f[0], ChambolleState(px=px[0], py=py[0], iters=iters_t[0], err=err[0])
    return f, ChambolleState(px=px, py=py, iters=iters_t, err=err)
