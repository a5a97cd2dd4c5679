"""Chambolle TV prox on the card: kernel A of `csrc/tv_kernels.cu`.

Replaces `semiblind_tv_tpu/ops/tv_pallas.py::chambolle_prox_pallas` — both
its warm form (`_kernel`, duals in and out: SALSA's prox, SALSA_v2.m:429)
and its fresh form (`_kernel_fresh`, zero duals, f only: the initial SAPG
prox and the SAPG prox when the fused step is off).  The TPU kernel runs
`dual_ascent_loop`/`neumann_div` with the image resident in VMEM; on Hopper
a 512² field does not fit one SM, so the image is cut into 32 × 64 tiles,
one block each, all resident at once (a cooperative launch), with the duals
in registers from the first sweep to the last; tiles exchange their borders
and the chain's residual through a per-chain barrier in device memory, and
a call is one launch (see the source's header).  `resident_geometry` picks
the grid: the tiles of as many chains as the card holds at once, the chains
in groups of that many; when the chains are more than that, each block
holds the tile of up to `stack` chains (the stacked form: their duals in
shared memory, one barrier a sweep for all of them), so that fewer groups
run one after another; a chain with more tiles than the card holds (above
about 512 × 1056) takes the walk form, each block sweeping several tiles in
turn with the duals in device memory.

`chambolle_prox_cuda` takes the plain version (`chambolle_prox_plain`, a
composition of ops/tv.py) for a CPU tensor and the kernel for a CUDA
tensor; anything else raises.  There is no fallback from the kernel: a
launch that CUDA refuses raises.
`chambolle_prox_resident_emulated` replays the kernel's schedule on the CPU:
the groups of chains, the stacked chains of a block swept in turn between
two barriers, per-tile residual partials in the kernel's thread, warp and
tile order, the per-chain fixed-order sum and each chain's own exit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import ChambolleState, chambolle_prox, divergence
from semiblind_tv_tpu_torch.runtime import profiling

__all__ = [
    "chambolle_prox_cuda", "chambolle_prox_plain", "chambolle_prox_resident_emulated",
    "dual_ascent_loop", "neumann_div", "resident_geometry", "resident_capacity",
    "resident_stack", "resident_occupancy", "resident_workspace", "resident_floats",
    "barrier_error",
    "tile_sums", "chain_total", "scalar_on", "chain_scalars", "per_chain",
    "TILE_ROWS", "TILE_COLS",
]

# Constants of csrc/tv_kernels.cu: warps across and down a block, rows of a
# thread's strip, the tile they make, floats of a tile's border record, and
# the blocks an SM of the design; DESIGN_CAPACITY is the resident blocks of
# an H100 (132 SMs) at that count, and DESIGN_STACK the chains a block of the
# stacked form holds there (KMAX of csrc/resident.cuh), which the CPU
# emulation and tests take.
WARPS_X = 2
WARPS_Y = 4
STRIP_ROWS = 8
TILE_ROWS = STRIP_ROWS * WARPS_Y        # 32
TILE_COLS = 32 * WARPS_X                # 64
BLOCK_THREADS = 32 * WARPS_X * WARPS_Y  # 256
BORDER_FLOATS = 3 * TILE_COLS + 3 * TILE_ROWS
BLOCKS_PER_SM = 2
DESIGN_CAPACITY = BLOCKS_PER_SM * 132
DESIGN_STACK = 3
WS_INT_HEAD = 2                         # error code, exit counter

# Launch counters (profiling.counters): `launches.A`, kernel-A launches (both
# forms) made by chambolle_prox_cuda; `launches.A.fresh`, of which in the
# fresh (zero-dual) form; `groups.A`, the chain groups those launches ran
# one after another (resident_geometry's `groups`).  Sweep counters:
# `sweeps.A1` (warm) and `sweeps.A2` (fresh), the plain version's included.


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
    f, st = chambolle_prox(g, per_chain(lam, g), max_iter, tau=tau, tol=tol, duals=duals)
    profiling.count_sweeps("A2" if duals is None else "A1", st.iters)
    if not return_state:
        zero = torch.zeros_like(f)
        st = ChambolleState(px=zero, py=zero, iters=st.iters, err=st.err)
    return f, st


def _chains(like: torch.Tensor) -> int:
    return like.shape[0] if like.ndim == 3 else 1


def scalar_on(value, like: torch.Tensor, name: str) -> Tuple[torch.Tensor, int]:
    """(tensor, chain stride) of a kernel's scalar pointer on `like`'s
    device: a Python number (a fill launch, no host-to-device copy) or a
    one-element float32 tensor gives a 0-d tensor that every chain reads
    (stride 0); a float32 tensor of one value for each of like's B chains,
    (B,) or (B, 1, 1), gives a (B,) vector that chain b reads at b (stride
    1) — the problems of a sharded run, each with its own γ, λ, θ and σ²."""
    if torch.is_tensor(value):
        B = _chains(like)
        if value.device != like.device or value.dtype != torch.float32 or value.numel() not in (
                1, B):
            raise ValueError(
                f"{name} must be a float32 tensor of 1 or {B} values on {like.device}, "
                f"got {value.dtype} {tuple(value.shape)} on {value.device}"
            )
        if value.numel() == 1:
            return value.reshape(()).contiguous(), 0
        return value.reshape(B).contiguous(), 1
    return torch.full((), float(value), dtype=torch.float32, device=like.device), 0


def chain_scalars(pairs, like: torch.Tensor) -> Tuple[list, int]:
    """scalar_on of each (value, name) pair: the tensors and the strides as
    the kernels' bit mask (bit i set: pair i is one value a chain)."""
    tensors, strides = [], 0
    for i, (value, name) in enumerate(pairs):
        t, s = scalar_on(value, like, name)
        tensors.append(t)
        strides |= s << i
    return tensors, strides


def per_chain(value, like: torch.Tensor):
    """The plain versions' form of a scalar: a tensor of one value for each
    of like's B chains (B > 1) as (B, 1, 1), which broadcasts against the
    (B, M, N) fields as the kernels read it; anything else as it is."""
    if torch.is_tensor(value) and like.ndim == 3 and value.ndim >= 1:
        B = like.shape[0]
        if value.numel() == B and B > 1:
            return value.reshape(B, 1, 1)
    return value


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


# ---------------------------------------------------------------------------
# Geometry, capacity and workspace of the resident kernel
# ---------------------------------------------------------------------------

class ResidentGeometry(NamedTuple):
    tile: Tuple[int, int]   # (rows, columns) of a tile
    tiles: int              # tiles of a chain (T)
    chains: int             # chains of a group (C), resident at once
    groups: int             # groups the launch walks through
    grid: int               # blocks of the launch: C/stack · T, or K < T (walk form)
    walk: int               # tiles a block sweeps in turn: 1 (resident form) or more
    stack: int = 1          # chains a block sweeps between two barriers


def resident_geometry(B: int, M: int, N: int, capacity: Optional[int] = None,
                      stack_max: int = DESIGN_STACK) -> ResidentGeometry:
    """The resident kernel's launch for B chains of (M, N): 32 × 64 tiles,
    T = ⌈M/32⌉·⌈N/64⌉ a chain.  When T ≤ capacity, P = capacity // T chains
    fit at one a block.  B ≤ P (the resident form): C = B chains at once,
    one group, a grid of B·T blocks, one a tile.  B > P: each block holds
    its tile of stack = min(⌈B/P⌉, stack_max) chains (1: the resident form;
    more: the stacked form), C = P·stack chains a group and ⌈B/C⌉ groups, a
    grid of P·T blocks; block k handles tile k mod T of the chains g·C +
    j·P + k // T (j < stack) in group g.  T > capacity (the walk form): one
    chain at a time, B groups, each block sweeping walk = ⌈T/capacity⌉
    tiles in turn, a grid of ⌈T/walk⌉ blocks.  capacity: the blocks the card
    holds at once (resident_capacity; by default the design's 2 an SM ×
    132); stack_max: the chains a block of the launching kernel may hold
    (by default the design's, which kernels A-E launch with; 1 for kernel
    J, which has no stacked form)."""
    cap = DESIGN_CAPACITY if capacity is None else int(capacity)
    if B < 1 or M < 2 or N < 2 or cap < 1 or stack_max < 1:
        raise ValueError(f"no resident geometry for B={B}, {M}x{N} at {cap} blocks "
                         f"and {stack_max} chains a block")
    T = -(-M // TILE_ROWS) * -(-N // TILE_COLS)
    if T > cap:
        walk = -(-T // cap)
        return ResidentGeometry((TILE_ROWS, TILE_COLS), T, 1, B, -(-T // walk), walk)
    P = cap // T
    if B <= P:
        return ResidentGeometry((TILE_ROWS, TILE_COLS), T, B, 1, B * T, 1)
    stack = min(-(-B // P), int(stack_max))
    C = P * stack
    return ResidentGeometry((TILE_ROWS, TILE_COLS), T, C, -(-B // C), P * T, 1, stack)


_OCCUPANCY = {}


def resident_occupancy(device) -> dict:
    """sb_resident_occupancy on `device` (cached): blocks an SM, registers
    and local bytes a thread, threads a block, the blocks an SM of
    __launch_bounds__, SMs, tile rows and columns, border floats, and the
    chains a block of the stacked form may hold (`stack_max`)."""
    from semiblind_tv_tpu_torch._build import load_library

    dev = torch.device(device)
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _OCCUPANCY:
        lib = load_library()
        out = (ctypes.c_int * 10)()
        with torch.cuda.device(key):
            check_status(lib.sb_resident_occupancy(out), "sb_resident_occupancy")
        names = ("blocks_per_sm", "registers", "local_bytes", "threads", "launch_bounds_blocks",
                 "sms", "tile_rows", "tile_cols", "border_floats", "stack_max")
        occ = dict(zip(names, list(out)))
        if (occ["tile_rows"], occ["tile_cols"], occ["border_floats"]) != (
                TILE_ROWS, TILE_COLS, BORDER_FLOATS):
            raise RuntimeError(f"csrc/tv_kernels.cu and ops/tv_cuda.py disagree: {occ}")
        _OCCUPANCY[key] = occ
    return _OCCUPANCY[key]


def resident_capacity(device) -> int:
    """Blocks of the resident kernel the card holds at once."""
    occ = resident_occupancy(device)
    return occ["blocks_per_sm"] * occ["sms"]


def resident_stack(device) -> int:
    """Chains a block of the stacked form holds on the card (1: none)."""
    return resident_occupancy(device)["stack_max"]


def resident_floats(geo: ResidentGeometry, M: int, N: int) -> int:
    """Workspace floats of a launch: the border records and the residual and
    TV partials, double-buffered, one a tile of a group's chains, and the
    walk form's two dual fields of one chain."""
    S = geo.chains * geo.tiles
    return 2 * S * (BORDER_FLOATS + 2) + (2 * M * N if geo.walk > 1 else 0)


_WORKSPACE = {}


def resident_workspace(device, stream, floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ws_int, ws_f) of the resident kernel for calls on `stream`: the error
    code, the exit counter and one arrival counter a chain slot, as many as
    the card holds chains (zero, and left zero by each launch), and at least
    `floats` floats (resident_floats; made again, larger, when a launch
    needs more).  Calls on one stream run in order, so they share it;
    another stream gets its own."""
    dev = torch.device(device)
    key = (dev.index, int(stream))
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = (torch.zeros((WS_INT_HEAD + resident_capacity(dev),), dtype=torch.int32, device=dev),
              torch.empty((0,), dtype=torch.float32, device=dev))
    if ws[1].numel() < floats:
        ws = (ws[0], torch.empty((int(floats),), dtype=torch.float32, device=dev))
    _WORKSPACE[key] = ws
    return ws


def barrier_error() -> int:
    """The largest error code the resident kernel left in any workspace
    (0: every barrier completed; 1: a barrier gave up, and the launch
    trapped, so the synchronisation here raises first).  Synchronises."""
    if not _WORKSPACE:
        return 0
    torch.cuda.synchronize()
    return max(int(ws[0][0]) for ws in _WORKSPACE.values())


def resident_launch(like: torch.Tensor, stack_max: Optional[int] = None):
    """(geometry, ws_int, ws_f, stream) of a resident launch over `like`'s
    (B, M, N) on its device's current stream; stack_max: the chains a block
    may hold (None: resident_stack, kernels A-E)."""
    B, M, N = like.shape
    stream = torch.cuda.current_stream(like.device).cuda_stream
    if stack_max is None:
        stack_max = resident_stack(like.device)
    geo = resident_geometry(B, M, N, resident_capacity(like.device), stack_max)
    ws_int, ws_f = resident_workspace(like.device, stream, resident_floats(geo, M, N))
    return geo, ws_int, ws_f, stream


_ZEROS = {}


def _zeros_like(f: torch.Tensor) -> torch.Tensor:
    """A zero field shaped like f, made once per shape and device (the duals
    of return_state=False; shared, not to be written)."""
    key = (f.device, tuple(f.shape))
    if key not in _ZEROS:
        _ZEROS[key] = torch.zeros_like(f)
    return _ZEROS[key]


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
    kernel does.  λ may be a Python number, a one-element device tensor or
    one value a chain (scalar_on)."""
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
        lam_t, strides = scalar_on(lam, g, "lam")
        geo, ws_int, ws_f, stream = resident_launch(g)
        iters = torch.empty((B,), dtype=torch.int32, device=g.device)
        err = torch.empty((B,), dtype=torch.float32, device=g.device)
        f = torch.empty_like(g)
        px = torch.empty_like(g) if return_state else None
        py = torch.empty_like(g) if return_state else None
        code = lib.sb_chambolle_prox(
            g.data_ptr(), lam_t.data_ptr(),
            duals[0].data_ptr() if duals is not None else None,
            duals[1].data_ptr() if duals is not None else None,
            f.data_ptr(), px.data_ptr() if px is not None else None,
            py.data_ptr() if py is not None else None, iters.data_ptr(), err.data_ptr(),
            ws_int.data_ptr(), ws_f.data_ptr(), B, M, N, geo.chains, geo.grid, geo.stack,
            int(max_iter), float(tau), float(tol), strides, stream,
        )
    check_status(code, "chambolle_prox_cuda")
    profiling.counters.add("launches.A")
    profiling.counters.add("groups.A", geo.groups)
    if duals is None:
        profiling.counters.add("launches.A.fresh")
    profiling.count_sweeps("A2" if duals is None else "A1", iters)
    if px is None:
        px = py = _zeros_like(f)
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


def tile_sums(v: torch.Tensor) -> torch.Tensor:
    """The resident kernel's per-tile sums of an (M, N) field (zero outside
    the image), tiles row-major: thread (warp w, lane l) adds the
    STRIP_ROWS rows of its strip of column 32·(w mod WARPS_X) + l in order,
    a shuffle tree sums each warp, then the warps are added in order w = 0,
    1, ...."""
    M, N = v.shape
    gy, gx = -(-M // TILE_ROWS), -(-N // TILE_COLS)
    pad = torch.zeros((gy * TILE_ROWS, gx * TILE_COLS), dtype=v.dtype)
    pad[:M, :N] = v
    # (tile row, warp row, strip row, tile column, warp column, lane)
    t = pad.view(gy, WARPS_Y, STRIP_ROWS, gx, WARPS_X, 32).permute(0, 3, 1, 4, 2, 5)
    acc = t[..., 0, :]
    for i in range(1, STRIP_ROWS):
        acc = acc + t[..., i, :]
    warps = _tree(acc).reshape(gy * gx, WARPS_Y * WARPS_X)   # warp w = WARPS_X·wy + wx
    s = warps[:, 0]
    for w in range(1, WARPS_Y * WARPS_X):
        s = s + warps[:, w]
    return s


def chain_total(partials: torch.Tensor) -> torch.Tensor:
    """tv_kernels.cu's sum of a chain's tile partials (gather): thread t of
    the BLOCK_THREADS adds partials t, t + BLOCK_THREADS, ... in order, a
    shuffle tree sums each warp, then the warps are added in order."""
    n = partials.shape[0]
    rows = -(-n // BLOCK_THREADS)
    pad = torch.zeros(rows * BLOCK_THREADS, dtype=partials.dtype)
    pad[:n] = partials
    acc = torch.zeros(BLOCK_THREADS, dtype=partials.dtype)
    for i in range(rows):
        acc = acc + pad[i * BLOCK_THREADS:(i + 1) * BLOCK_THREADS]
    warps = _tree(acc.view(-1, 32))
    s = warps[0]
    for w in range(1, warps.shape[0]):
        s = s + warps[w]
    return s


def _sweep(px, py, glam, tau):
    """One sweep of the kernel's per-pixel operations on whole (M, N)
    fields: (new px, new py, residual field)."""
    u = divergence(px, py) - glam
    zr = torch.zeros_like(u[:1])
    zc = torch.zeros_like(u[:, :1])
    upx = torch.cat([u[1:] - u[:-1], zr], dim=0)
    upy = torch.cat([u[:, 1:] - u[:, :-1], zc], dim=1)
    tmp = torch.sqrt(upx * upx + upy * upy)
    rx = -upx + tmp * px
    ry = -upy + tmp * py
    denom = 1.0 + tau * tmp
    return (px + tau * upx) / denom, (py + tau * upy) / denom, rx * rx + ry * ry


def chambolle_prox_resident_emulated(
    g: torch.Tensor,
    lam,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_state: bool = True,
    capacity: Optional[int] = None,
    stack_max: int = DESIGN_STACK,
) -> Tuple[torch.Tensor, ChambolleState]:
    """The resident kernel's schedule in PyTorch, on the CPU: the groups of
    resident_geometry(B, M, N, capacity, stack_max), and in each the slots
    of `stack` chains, a block's chains.  A slot's sweep round sweeps each
    of its running chains once, then one barrier gives every one of them its
    residual, the fixed-order sum (chain_total) of the tiles' partials
    (tile_sums); a chain whose residual is ≤ tol leaves (that sweep still
    applied) and keeps its duals, and the slot sweeps on while any of its
    chains runs.  Then f = g − λ·div p.  The per-pixel operations are the
    kernel's, on whole fields (a tile's border exchange gives each pixel the
    same neighbours).  Same signature and results as chambolle_prox_cuda
    otherwise."""
    squeeze = g.ndim == 2
    if squeeze:
        g = g[None]
        if duals is not None:
            duals = (duals[0][None], duals[1][None])
    if not return_state and duals is not None:
        raise ValueError("return_state=False requires duals=None (fresh duals)")
    B, M, N = g.shape
    geo = resident_geometry(B, M, N, capacity, stack_max)
    lam = per_chain(lam, g)
    px_all = torch.zeros_like(g) if duals is None else duals[0].clone()
    py_all = torch.zeros_like(g) if duals is None else duals[1].clone()
    iters = torch.zeros((B,), dtype=torch.int32)
    err = torch.full((B,), float("inf"), dtype=g.dtype)
    slots = geo.chains // geo.stack
    seen = []
    for grp in range(geo.groups):
        for slot in range(slots):
            chains = [b for b in (grp * geo.chains + k * slots + slot for k in range(geo.stack))
                      if b < B]
            seen += chains
            glam = {b: g[b] / (lam[b] if torch.is_tensor(lam) and lam.ndim == 3 else lam)
                    for b in chains}
            live = list(chains)
            for s in range(max_iter):
                if not live:
                    break
                r2 = {}
                for b in live:   # the block's running chains, in turn
                    px_all[b], py_all[b], r2[b] = _sweep(px_all[b], py_all[b], glam[b], tau)
                for b in list(live):   # one barrier: each chain's residual and exit
                    e = torch.sqrt(chain_total(tile_sums(r2[b])))
                    iters[b], err[b] = s + 1, e
                    if not bool(e > tol):
                        live.remove(b)
    if sorted(seen) != list(range(B)):
        raise AssertionError(f"the groups cover chains {seen}, not each of {B} once")
    f = g - lam * divergence(px_all, py_all)
    if not return_state:
        px_all = py_all = torch.zeros_like(f)
    if squeeze:
        return f[0], ChambolleState(px=px_all[0], py=py_all[0], iters=iters[0], err=err[0])
    return f, ChambolleState(px=px_all, py=py_all, iters=iters, err=err)
