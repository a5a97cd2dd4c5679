"""Where does a Chambolle sweep's time go on the card?  Eleven variants of
the fresh-dual prox, each changing one class of operation.

Port of the JAX package's `benchmarks/probe_prox_variants.py` (TPU kernel
J: `build`'s `pallas_call`, `make_kernel`).  Every mode computes
f = g − λ·div p after at most `max_iter` Chambolle sweeps on g/λ from zero
duals, and meta = (sweeps run, last residual) per chain:

    base      2 divides; masked loop (every chain computes every sweep and
              keeps its old duals once stopped), residual every sweep
    recip     one reciprocal and 2 multiplies instead of the divides
    noresid   recip without the residual and the early exit (meta =
              (max_iter, 0)): what the exit machinery costs
    nosqrt    noresid with |∇u| := upx² + upy² (WRONG math: the sqrt's cost)
    while     recip with a true early exit: a stopped chain does no work
    roll      while with the image-boundary terms formed by select masks
    rollmul   while with the boundary terms formed by 0/1 multiplicative
              masks.  roll and rollmul equal while exactly: the port keeps
              the concatenate form's values, as J's comment intends.  (J's
              TPU roll form, written with circular rolls, takes the textbook
              −p[M−2] at the last row and column instead of the reference's
              −p[M−1]; at the probe's λ = 0.08 that moves f by ~2e-7
              relative, at λ = 20 by several per cent.)
    every5    while with the residual only on sweeps 5, 10, ...: the exit
              can fire only there
    bf16mix   duals and the stencil adds/subs in bfloat16; sqrt, reciprocal
              and residual in float32
    bf16      all sweep arithmetic in bfloat16, residual in float32
    bf16all   bf16 with the residual terms in bfloat16 too (float32 sum)

A bfloat16 operation is the float32 operation on bfloat16 values rounded
once to bfloat16, as PyTorch computes it (also for sqrt and the
reciprocal, which the v5e TPU could not lower in bf16).

`prox_variant(mode, g, scal, max_iter)` launches `csrc/prox_variants.cu`
for a CUDA tensor and runs `prox_variant_plain` for a CPU tensor; anything
else raises.  g is (B, M, N) float32, scal a (3,) float32 tensor of
(λ, τ, tol) on g's device, read by the kernel on the device.  The kernel
is one cooperative launch a call on the resident design of kernels A–C
(`csrc/resident.cuh`, geometry and workspace from `ops/tv_cuda.py`): the
duals in registers, borders and residual partials through the per-chain
barrier, the mode a policy of the sweep and of what the barrier carries.
`launches.J` (profiling.counters) counts the kernel's launches and
`groups.J` their chain groups (one chain a block: J has no stacked form).
`prox_variant_resident_emulated` replays the kernel's schedule on the CPU
(chain groups, the walk form, per-tile partials in the kernel's order, the
exit as each mode takes it).

On the card (needs one CUDA card; there is no CPU fallback):

    python -m semiblind_tv_tpu_torch.benchmarks.probe_prox_variants

knobs PROBE_CHAINS (16), PROBE_SIZE (512), PROBE_SWEEPS (25), PROBE_STEPS
(100) and PROBE_MODES (base,recip,while,noresid,nosqrt).  Prints the
card's name and power limit, then one JSON line per mode: µs per prox per
chain and per sweep over PROBE_STEPS chained calls (f·1.000001 fed back,
CUDA events after one warm pass), max|f − f_base| on the same input, and
chain 0's sweep count.  A mode that fails prints its error line, and the
process then exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback
from typing import Optional, Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import divergence, forward_gradient
from semiblind_tv_tpu_torch.ops.tv_cuda import (
    chain_total,
    check_fields,
    check_status,
    resident_geometry,
    resident_launch,
    tile_sums,
)
from semiblind_tv_tpu_torch.runtime import profiling

__all__ = [
    "MODES", "BF16_MODES", "NO_RESIDUAL", "MASKED", "prox_variant", "prox_variant_plain",
    "prox_variant_resident_emulated", "variant_occupancy", "probe_inputs", "probe_mode",
    "card_line", "main",
]

MODES = ("base", "recip", "noresid", "nosqrt", "while", "roll", "rollmul", "every5",
         "bf16mix", "bf16", "bf16all")   # the kernel's mode ids are the indices
BF16_MODES = ("bf16mix", "bf16", "bf16all")
NO_RESIDUAL = ("noresid", "nosqrt")
MASKED = ("base", "recip")   # a stopped chain sweeps on to max_iter, keeping its duals


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _variant_sweep(mode: str, px: torch.Tensor, py: torch.Tensor, glam: torch.Tensor,
                   tau: torch.Tensor, check: bool):
    """One sweep of `mode` on whole fields in the dual type of px: (new px,
    new py, the residual field r2, float32 — None unless `check`)."""
    all_bf = mode in ("bf16", "bf16all")
    dual = px.dtype
    upx, upy = forward_gradient(divergence(px, py) - glam)
    r2 = None
    if all_bf:
        tau_s = tau.to(dual)
        tmp = torch.sqrt(upx * upx + upy * upy)
        if check and mode == "bf16":
            rx = -upx.float() + tmp.float() * px.float()
            ry = -upy.float() + tmp.float() * py.float()
            r2 = rx * rx + ry * ry
        elif check:
            rx = -upx + tmp * px
            ry = -upy + tmp * py
            r2 = (rx * rx + ry * ry).float()
        rden = 1.0 / (1.0 + tau_s * tmp)
        return (px + tau_s * upx) * rden, (py + tau_s * upy) * rden, r2
    bf = mode in BF16_MODES
    p1, p2 = (px.float(), py.float()) if bf else (px, py)
    if bf:
        upx, upy = upx.float(), upy.float()
    s2 = upx * upx + upy * upy
    tmp = s2 if mode == "nosqrt" else torch.sqrt(s2)
    if check:
        rx = -upx + tmp * p1
        ry = -upy + tmp * p2
        r2 = rx * rx + ry * ry
    if mode == "base":
        denom = 1.0 + tau * tmp
        npx = (p1 + tau * upx) / denom
        npy = (p2 + tau * upy) / denom
    else:
        rden = 1.0 / (1.0 + tau * tmp)
        npx = (p1 + tau * upx) * rden
        npy = (p2 + tau * upy) * rden
    return npx.to(dual), npy.to(dual), r2


def _checks(mode: str, s: int) -> bool:
    """Whether sweep s (from 0) of `mode` takes the residual and may exit."""
    return mode not in NO_RESIDUAL and (mode != "every5" or (s + 1) % 5 == 0)


def prox_variant_plain(mode: str, g: torch.Tensor, scal: torch.Tensor,
                       max_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of one mode: (f, meta), meta (B, 2)
    float32 = (sweeps run, last residual).  Every mode runs as a masked loop
    (a stopped chain keeps its duals), which equals a true early exit."""
    _check_mode(mode)
    lam, tau, tol = scal[0], scal[1], scal[2]
    B = g.shape[0]
    dev = g.device
    resid = mode not in NO_RESIDUAL
    dual = torch.bfloat16 if mode in BF16_MODES else g.dtype
    glam = (g / lam).to(dual)
    px = torch.zeros(g.shape, dtype=dual, device=dev)
    py = torch.zeros_like(px)
    k = torch.zeros((B,), dtype=torch.float32, device=dev)
    err = torch.full((B,), float("inf") if resid else 0.0, dtype=torch.float32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    for s in range(max_iter):
        check = _checks(mode, s)
        npx, npy, r2 = _variant_sweep(mode, px, py, glam, tau, check)
        if not resid:
            px, py = npx, npy
            continue
        a3 = active[:, None, None]
        px = torch.where(a3, npx, px)
        py = torch.where(a3, npy, py)
        k = k + active.to(torch.float32)
        if check:
            step_err = torch.sqrt(torch.sum(r2, dim=(-2, -1))).to(torch.float32)
            err = torch.where(active, step_err, err)
            active = torch.logical_and(active, step_err > tol)
    if not resid:
        k = torch.full((B,), float(max_iter), dtype=torch.float32, device=dev)
    f = g - lam * divergence(px.to(g.dtype), py.to(g.dtype))
    return f, torch.stack([k, err], dim=1)


def _tile_partials(sums: torch.Tensor, geo) -> torch.Tensor:
    """The chain's partials as the kernel's blocks write them: in the
    resident form block k of a chain slot owns tile k mod T, in the walk
    form block k sweeps tiles k, k + K, ... in turn; each tile's partial
    goes to its own slot, so the chain's sum has one order in both."""
    T = sums.shape[0]
    K = geo.grid if geo.walk > 1 else T
    part = torch.full_like(sums, float("nan"))
    owner = [None] * T
    for k in range(K):
        for tile in range(k, T, K):
            if owner[tile] is not None:
                raise AssertionError(f"tile {tile} swept by blocks {owner[tile]} and {k}")
            owner[tile] = k
            part[tile] = sums[tile]
    if None in owner:
        raise AssertionError(f"tiles {[t for t, o in enumerate(owner) if o is None]} unswept")
    return part


def prox_variant_resident_emulated(mode: str, g: torch.Tensor, scal: torch.Tensor, max_iter: int,
                                   capacity: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel J's schedule replayed in PyTorch on the CPU: the chain groups
    (or the walk form) of resident_geometry(B, M, N, capacity); each chain
    swept from zero duals with the mode's per-pixel operations
    (prox_variant_plain's, on whole fields: a tile's border exchange gives
    each pixel the same neighbours); on a sweep that checks, the residual
    is the fixed-order sum (tv_cuda.chain_total) of the tiles' partials
    (tv_cuda.tile_sums, the kernel's thread, warp and tile order); the exit
    as the kernel takes it — a masked mode (base, recip) sweeps on to
    max_iter keeping its stopped duals (the barrier then carries borders
    only), `while` and the others leave, every5
    tests only on sweeps 5, 10, ..., noresid and nosqrt never; then f =
    g − λ·div p.  Same results as prox_variant; meta's residual is the
    kernel's sum."""
    _check_mode(mode)
    if g.ndim != 3:
        raise ValueError(f"g must be (B, M, N), got {tuple(g.shape)}")
    B, M, N = g.shape
    geo = resident_geometry(B, M, N, capacity, 1)
    lam, tau, tol = scal[0], scal[1], scal[2]
    resid = mode not in NO_RESIDUAL
    masked = mode in MASKED
    dual = torch.bfloat16 if mode in BF16_MODES else g.dtype
    f = torch.empty_like(g)
    meta = torch.zeros((B, 2), dtype=torch.float32, device=g.device)
    seen = []
    for grp in range(geo.groups):
        for slot in range(geo.chains):
            b = grp * geo.chains + slot
            if b >= B:
                continue
            seen.append(b)
            glam = (g[b] / lam).to(dual)
            px = torch.zeros((M, N), dtype=dual, device=g.device)
            py = torch.zeros_like(px)
            n, e = 0, torch.tensor(float("inf") if resid else 0.0)
            for s in range(max_iter):
                keep = masked and not bool(e > tol)
                check = _checks(mode, s) and not keep
                npx, npy, r2 = _variant_sweep(mode, px, py, glam, tau, check)
                if not keep:
                    px, py = npx, npy
                    n = s + 1
                if check:
                    e = torch.sqrt(chain_total(_tile_partials(tile_sums(r2.to(torch.float32)),
                                                              geo)))
                if not masked and check and not bool(e > tol):
                    break
            f[b] = g[b] - lam * divergence(px.to(g.dtype), py.to(g.dtype))
            meta[b, 0], meta[b, 1] = float(n), e
    if sorted(seen) != list(range(B)):
        raise AssertionError(f"the groups cover chains {seen}, not each of {B} once")
    return f, meta


def prox_variant(mode: str, g: torch.Tensor, scal: torch.Tensor,
                 max_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One mode of the probe: the kernel for a CUDA tensor, the plain
    version for a CPU tensor.  g (B, M, N) float32, scal (3,) float32
    (λ, τ, tol) on g's device; returns (f, meta).  One launch a call; it
    allocates f and meta, and the resident workspace the first time."""
    _check_mode(mode)
    if g.device.type == "cpu":
        return prox_variant_plain(mode, g, scal, max_iter)
    if g.device.type != "cuda":
        raise ValueError(f"prox_variant: unsupported device {g.device}")
    from semiblind_tv_tpu_torch._build import load_library

    if g.ndim != 3:
        raise ValueError(f"g must be (B, M, N), got {tuple(g.shape)}")
    check_fields(["g"], [g], g)
    if scal.device != g.device or scal.dtype != torch.float32 or tuple(scal.shape) != (3,) \
            or not scal.is_contiguous():
        raise ValueError(f"scal must be a contiguous (3,) float32 tensor on {g.device}, got "
                         f"{scal.dtype} {tuple(scal.shape)} on {scal.device}")
    lib = load_library()
    B, M, N = g.shape
    with torch.cuda.device(g.device):
        geo, ws_int, ws_f, stream = resident_launch(g, stack_max=1)
        f = torch.empty_like(g)
        meta = torch.empty((B, 2), dtype=torch.float32, device=g.device)
        code = lib.sb_prox_variant(
            MODES.index(mode), g.data_ptr(), scal.data_ptr(), f.data_ptr(), meta.data_ptr(),
            ws_int.data_ptr(), ws_f.data_ptr(), B, M, N, geo.chains, geo.grid, int(max_iter),
            stream,
        )
    check_status(code, f"prox_variant({mode})")
    profiling.counters.add("launches.J")
    profiling.counters.add("groups.J", geo.groups)
    return f, meta


def variant_occupancy(mode: str, device) -> dict:
    """sb_prox_variant_occupancy of `mode` on `device`: blocks an SM (the
    smaller of its resident and walk forms), registers and local (spill)
    bytes a thread (the larger)."""
    import ctypes

    from semiblind_tv_tpu_torch._build import load_library

    _check_mode(mode)
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(torch.device(device)):
        check_status(load_library().sb_prox_variant_occupancy(MODES.index(mode), out),
                     "sb_prox_variant_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes"), list(out)))


def probe_inputs(B: int, size: int, device, seed: int = 0):
    """J's inputs: a uniform [0, 255) field and scal = (λ 0.02·4, τ 0.249,
    tol 1e-3), made on `device` from a seeded generator."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = torch.rand((B, size, size), generator=gen, device=device) * 255.0
    scal = torch.tensor([0.02 * 4.0, 0.249, 1e-3], dtype=torch.float32, device=device)
    return g, scal


def probe_mode(mode: str, g: torch.Tensor, scal: torch.Tensor, sweeps: int, steps: int,
               f_base: torch.Tensor) -> dict:
    """J's timing of one mode on the card: `steps` chained calls feeding
    f·1.000001 back, timed with CUDA events after one warm pass."""
    def loop():
        c = g
        for _ in range(steps):
            c = prox_variant(mode, c, scal, sweeps)[0] * 1.000001
        return c

    loop()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loop()
    end.record()
    end.synchronize()
    us = start.elapsed_time(end) * 1e3 / steps / g.shape[0]
    f1, meta = prox_variant(mode, g, scal, sweeps)
    return dict(mode=mode, us_per_prox_per_chain=us, us_per_sweep=us / sweeps,
                maxdiff_vs_base=float((f1 - f_base).abs().max()), iters=float(meta[0, 0]))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the probe times the card: torch.cuda.is_available() is False")
    B = int(os.environ.get("PROBE_CHAINS", "16"))
    size = int(os.environ.get("PROBE_SIZE", "512"))
    sweeps = int(os.environ.get("PROBE_SWEEPS", "25"))
    steps = int(os.environ.get("PROBE_STEPS", "100"))
    modes = os.environ.get("PROBE_MODES", "base,recip,while,noresid,nosqrt").split(",")
    print(card_line(), flush=True)
    g, scal = probe_inputs(B, size, torch.device("cuda"))
    f_base = prox_variant("base", g, scal, sweeps)[0]
    failed = False
    for mode in modes:
        try:
            line = probe_mode(mode, g, scal, sweeps, steps, f_base)
        except Exception as e:  # noqa: BLE001 — report the mode, go on, fail at the end
            traceback.print_exc()
            line = dict(mode=mode, error=str(e)[:300])
            failed = True
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
