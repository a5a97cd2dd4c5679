"""Chambolle TV prox above 512² on the card: the temporally-blocked kernel
of `csrc/tv_blocked.cu`.

Replaces `semiblind_tv_tpu/ops/tv_pallas.py::chambolle_prox_tiled` (kernel
F, 1024²: duals in whole-image VMEM scratch, row tiles) and
`chambolle_prox_streamed` / `streamed_call` modes plain and warm (kernel H,
≥2048²: duals ping-pong in HBM, K sweeps per row window, a mid-pass redo
for an exact early exit).  Both become one Hopper design: 2-D tiles with a
halo of K on every side, K sweeps per window in shared memory, duals
ping-pong in device memory, per-tile per-sweep residual partials, a
per-chain reduce and a redo launch (see the source's header).  SALSA takes
the warm form (duals in and out) and the SAPG's initial prox the fresh form.

`chambolle_prox_blocked` takes the plain version (`chambolle_prox_blocked_plain`,
ops/tv.py::chambolle_prox) for a CPU tensor and the kernel for a CUDA
tensor; anything else raises.  `chambolle_prox_blocked_emulated` replays
the kernel's schedule in PyTorch — windows, halos, per-tile per-sweep
partials summed in the kernel's order, the reduce and the redo — so the
CPU tests hold that schedule against the whole-image prox.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import ChambolleState, divergence
from semiblind_tv_tpu_torch.ops.tv_cuda import (
    chambolle_prox_plain,
    check_fields,
    check_status,
    scalar_on,
)

__all__ = [
    "chambolle_prox_blocked", "chambolle_prox_blocked_plain",
    "chambolle_prox_blocked_emulated", "blocked_geometry", "blocked_rung",
    "check_geometry", "LAUNCHES", "FRESH_LAUNCHES", "SWEEP_BLOCK",
]

# Constants of csrc/tv_blocked.cu: threads of a pass block, window pixels
# per thread, most sweeps per pass; and of csrc/common.cuh: threads of the
# per-chain reduce block.
BLOCK_THREADS = 640
PIXELS_PER_THREAD = 10
SWEEP_BLOCK = 8
REDUCE_THREADS = 256
WINDOW_PIXELS = BLOCK_THREADS * PIXELS_PER_THREAD
# Shared memory of one H100 SM is 228 KB (227 KB for one block); a pass
# block keeps four f32 windows (g/λ, px, py, u), and two blocks should fit.
WINDOW_FIELDS = 4
SMEM_PER_BLOCK = 113 * 1024

LAUNCHES = 0         # blocked-prox launches (both forms) made by chambolle_prox_blocked
FRESH_LAUNCHES = 0   # of which in the fresh (zero-dual) form

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


def blocked_geometry(M: int, N: int, itemsize: int = 4) -> Tuple[int, int, int]:
    """(TY, TX, K) of the blocked kernel: the Hopper counterpart of
    tv_pallas.streamed_tile_rows, sized to shared memory instead of VMEM.

    K = 8 sweeps per pass.  The central tile is the largest square T (a
    multiple of 16) whose window (T + 2K)² fits the block's pixel capacity
    (640 threads × 10 pixels = 6400) and whose four f32 window fields (g/λ,
    px, py, u) fit half of an SM's shared memory, so that two blocks share
    an SM: T = 64, an 80 × 80 window, 4 × 25.6 KB = 102.4 KB.  Its cost:
    (80/64)² = 1.56×
    the stencil work of the central pixels, and device-memory traffic of
    about (3 · 1.56 + 2) / 8 ≈ 0.8 fields a sweep instead of about five.
    Windows clamp to the image, so any M, N ≥ 2 works; an image smaller
    than a window is one window."""
    K = SWEEP_BLOCK
    for t in (64, 48, 32, 16):
        w = t + 2 * K
        if w * w <= WINDOW_PIXELS and WINDOW_FIELDS * w * w * itemsize <= SMEM_PER_BLOCK:
            return t, t, K
    raise ValueError(f"no blocked tile fits for M={M}, N={N}")


def check_geometry(geometry, M, N):
    """Raise unless (TY, TX, K) fits the kernel (K ≤ 8, window ≤ 6400
    pixels); returns it."""
    TYb, TXb, K = geometry
    wh, ww = min(TYb + 2 * K, M), min(TXb + 2 * K, N)
    if not (1 <= K <= SWEEP_BLOCK and TYb >= 1 and TXb >= 1 and wh * ww <= WINDOW_PIXELS):
        raise ValueError(f"geometry {geometry} does not fit the kernel (window {wh}x{ww})")
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
    global LAUNCHES, FRESH_LAUNCHES
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
    TYb, TXb, K = check_geometry(blocked_geometry(M, N), M, N)
    lib = load_library()
    ntiles = -(-M // TYb) * -(-N // TXb)
    with torch.cuda.device(g.device):
        lam_t = scalar_on(lam, g, "lam")
        dev = g.device
        px_buf = torch.empty((2, B, M, N), dtype=torch.float32, device=dev)
        py_buf = torch.empty_like(px_buf)
        state = torch.empty((B, 6), dtype=torch.int32, device=dev)
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
            B, M, N, TYb, TXb, K, int(max_iter), float(tau), float(tol), stream,
        )
    check_status(code, "chambolle_prox_blocked")
    LAUNCHES += 1
    if duals is None:
        FRESH_LAUNCHES += 1
    if px is None:
        px = py = torch.zeros_like(f)
    iters = state[:, 0].contiguous()
    if squeeze:
        f, px, py, iters, err = f[0], px[0], py[0], iters[0], err[0]
    return f, ChambolleState(px=px, py=py, iters=iters, err=err)


# ---------------------------------------------------------------------------
# The kernel's schedule, replayed in PyTorch
# ---------------------------------------------------------------------------

def _tree(v: torch.Tensor) -> torch.Tensor:
    """Fixed-order tree over the last dim (a power of two): step s adds
    v[s:2s] to v[:s], as a warp shuffle-down tree and common.cuh's
    shared-memory trees do."""
    v = v.clone()
    s = v.shape[-1] // 2
    while s > 0:
        v[..., :s] = v[..., :s] + v[..., s:2 * s]
        s //= 2
    return v[..., 0]


def _block_sum(r2: torch.Tensor) -> torch.Tensor:
    """blocked_pass's per-tile sum of (T, n) window values (zero outside
    the central tile): thread t sums pixels t, t + 640, ... in order, a
    shuffle tree sums each warp, then the warps are added in order."""
    T, n = r2.shape
    rows = -(-n // BLOCK_THREADS)
    pad = torch.zeros((T, rows * BLOCK_THREADS), dtype=r2.dtype)
    pad[:, :n] = r2
    pad = pad.view(T, rows, BLOCK_THREADS)
    acc = torch.zeros((T, BLOCK_THREADS), dtype=r2.dtype)
    for i in range(rows):
        acc = acc + pad[:, i]
    warps = _tree(acc.view(T, BLOCK_THREADS // 32, 32))
    s = warps[:, 0]
    for w in range(1, BLOCK_THREADS // 32):
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
    blocked_init, then per pass of up to K sweeps blocked_pass (every tile
    of every active chain: clamped window, K local sweeps, central tile to
    the other buffer, per-sweep partials in the kernel's summation order),
    blocked_reduce (first sweep j* with sqrt(sum) ≤ tol, state update) and
    the redo pass from the intact source with limit j*, then assembly.
    geometry = (TY, TX, K), by default blocked_geometry's.  Same signature
    and results as chambolle_prox_blocked otherwise."""
    squeeze = g.ndim == 2
    if squeeze:
        g = g[None]
        if duals is not None:
            duals = (duals[0][None], duals[1][None])
    if not return_state and duals is not None:
        raise ValueError("return_state=False requires duals=None (fresh duals)")
    B, M, N = g.shape
    TYb, TXb, K = check_geometry(geometry or blocked_geometry(M, N), M, N)
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
        glam = gather(g[b] / lam)   # elementwise: the same values as per pixel
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
                partials[b, s] = _block_sum(r2.reshape(T, wh * ww))
            denom = 1.0 + tau * tmp
            px, py = (px + tau * upx) / denom, (py + tau * upy) / denom
        for t, (h0, w0, r0, r1, c0, c1) in enumerate(tiles):
            buf[s_to, 0, b, h0 + r0:h0 + r1, w0 + c0:w0 + c1] = px[t, r0:r1, c0:c1]
            buf[s_to, 1, b, h0 + r0:h0 + r1, w0 + c0:w0 + c1] = py[t, r0:r1, c0:c1]

    for s0 in range(0, max_iter, K):
        limit = min(K, max_iter - s0)
        dst = {}
        for b in range(B):                    # blocked_pass
            if active[b]:
                dst[b] = 1 if src[b] == 0 else 0
                run_pass(b, src[b], dst[b], limit, True)
        redo = {}
        for b in dst:                         # blocked_reduce
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
