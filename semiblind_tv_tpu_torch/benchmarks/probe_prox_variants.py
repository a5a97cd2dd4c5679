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
(λ, τ, tol) on g's device.  LAUNCHES counts the kernel's launches.

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
from typing import Tuple

import torch

from semiblind_tv_tpu_torch.ops.tv import divergence, forward_gradient
from semiblind_tv_tpu_torch.ops.tv_cuda import check_fields, check_status

__all__ = [
    "MODES", "BF16_MODES", "NO_RESIDUAL", "prox_variant", "prox_variant_plain",
    "probe_inputs", "probe_mode", "card_line", "main", "LAUNCHES",
]

MODES = ("base", "recip", "noresid", "nosqrt", "while", "roll", "rollmul", "every5",
         "bf16mix", "bf16", "bf16all")   # the kernel's mode ids are the indices
BF16_MODES = ("bf16mix", "bf16", "bf16all")
NO_RESIDUAL = ("noresid", "nosqrt")
LAUNCHES = 0   # prox_variant launches of csrc/prox_variants.cu


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def prox_variant_plain(mode: str, g: torch.Tensor, scal: torch.Tensor,
                       max_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of one mode: (f, meta), meta (B, 2)
    float32 = (sweeps run, last residual).  Every mode runs as a masked loop
    (a stopped chain keeps its duals), which equals a true early exit."""
    _check_mode(mode)
    lam, tau, tol = scal[0], scal[1], scal[2]
    B = g.shape[0]
    dev = g.device
    bf = mode in BF16_MODES
    all_bf = mode in ("bf16", "bf16all")
    resid = mode not in NO_RESIDUAL
    dual = torch.bfloat16 if bf else g.dtype
    glam = (g / lam).to(dual)
    tau_s = tau.to(dual) if all_bf else tau
    px = torch.zeros(g.shape, dtype=dual, device=dev)
    py = torch.zeros_like(px)
    k = torch.zeros((B,), dtype=torch.float32, device=dev)
    err = torch.full((B,), float("inf") if resid else 0.0, dtype=torch.float32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    for s in range(max_iter):
        check = resid and (mode != "every5" or (s + 1) % 5 == 0)
        upx, upy = forward_gradient(divergence(px, py) - glam)
        r2 = None
        if all_bf:
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
            npx = (px + tau_s * upx) * rden
            npy = (py + tau_s * upy) * rden
        else:
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
            npx, npy = npx.to(dual), npy.to(dual)
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


def prox_variant(mode: str, g: torch.Tensor, scal: torch.Tensor,
                 max_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One mode of the probe: the kernel for a CUDA tensor, the plain
    version for a CPU tensor.  g (B, M, N) float32, scal (3,) float32
    (λ, τ, tol) on g's device; returns (f, meta)."""
    global LAUNCHES
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
    dev = g.device
    with torch.cuda.device(dev):
        dual = torch.bfloat16 if mode in BF16_MODES else torch.float32
        px_buf = torch.empty((2, B, M, N), dtype=dual, device=dev)
        py_buf = torch.empty_like(px_buf)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        err = torch.empty((B,), dtype=torch.float32, device=dev)
        active = torch.empty((B,), dtype=torch.int32, device=dev)
        partials = torch.empty((B, lib.sb_num_tiles(M, N)), dtype=torch.float32, device=dev)
        f = torch.empty_like(g)
        meta = torch.empty((B, 2), dtype=torch.float32, device=dev)
        code = lib.sb_prox_variant(
            MODES.index(mode), g.data_ptr(), scal.data_ptr(), px_buf.data_ptr(),
            py_buf.data_ptr(), iters.data_ptr(), err.data_ptr(), active.data_ptr(),
            partials.data_ptr(), f.data_ptr(), meta.data_ptr(), B, M, N, int(max_iter),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(code, f"prox_variant({mode})")
    LAUNCHES += 1
    return f, meta


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
