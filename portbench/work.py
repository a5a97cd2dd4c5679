"""Operations and bytes of the port's spatial kernels, and their roofline bound.

Frozen copy of `chip_smoke.py` at commit c8d401c3512c32400c85205db3b41830d3fef4be:
`PEAK_FP32`, `HBM_BYTES_PER_S`, `SWEEP_FLOP`, `PROX_FLOP`, `STEP_FLOP`,
`prox_work`, `step_work` and `bound` (unchanged).  `transform_work`,
`sapg_iter_work` and `salsa_iter_work` are the benchmark's own: the
operations of a whole SAPG or SALSA iteration, for the `mfu` metrics.

Peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet): 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM.  An add, subtract,
multiply, divide or sqrt counts one operation (a divide or sqrt takes
several instructions, so the bound stays a lower bound); selects and
negations are not counted.  Per pixel: a Chambolle sweep 26 (div p − g/λ
and ∇u 6, |∇u| 4, residual 8, update 8), a prox 6 more (g/λ once,
f = g − λ·div p), a MYULA step 16 more (the update 9, its circular TV 7);
sweeps are those the data ran, summed over the chains.
"""
from __future__ import annotations

import math

PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
SWEEP_FLOP, PROX_FLOP, STEP_FLOP = 26, 6, 16


def prox_work(B, M, N, sweeps, duals_io=False):
    """(operations, bytes) of a prox over B chains that ran `sweeps` sweeps
    in all: g in and f out, plus the duals in and out in the warm form."""
    return (M * N * (SWEEP_FLOP * sweeps + PROX_FLOP * B),
            4 * B * M * N * (6 if duals_io else 2))


def step_work(B, M, N, sweeps, seeds=False):
    """(operations, bytes) of a fused MYULA step: x, prox, grad and z (or
    the (B, 2) seeds) in, xn, proxn and tv out."""
    fields = 5 if seeds else 6
    return (M * N * (SWEEP_FLOP * sweeps + (PROX_FLOP + STEP_FLOP) * B),
            4 * B * M * N * fields + 4 * B + (8 * B if seeds else 0))


def bound(work, peak=PEAK_FP32, key="bound"):
    """{key}_ms and {key}_by of (operations, bytes) at `peak` operations/s."""
    t_ops, t_bytes = work[0] / peak, work[1] / HBM_BYTES_PER_S
    return {f"{key}_ms": max(t_ops, t_bytes) * 1e3,
            f"{key}_by": "operations" if t_ops >= t_bytes else "bytes"}


def transform_work(B, M, N):
    """Operations of one real 2-D FFT of B (M, N) fields, by the usual
    count of 2.5·MN·log2(MN) for a real transform."""
    return 2.5 * B * M * N * math.log2(M * N)


def sapg_iter_work(B, M, N, sweeps):
    """Operations of one SAPG iteration counted from its shapes: the fused
    step, the inverse and forward transforms, and the spectral products
    (R̂ = H·X̂ − ŷ, conj(H)·R̂, the residual after the step and its
    Parseval norm: about 24 operations a half-spectrum value a chain).
    The PSF's own operations are too few to count."""
    half = B * M * (N // 2 + 1)
    return step_work(B, M, N, sweeps)[0] + 2 * transform_work(B, M, N) + 24 * half


def salsa_iter_work(M, N, sweeps):
    """Operations of one SALSA outer iteration: the warm prox, a forward
    and an inverse transform, the spectral update (about 10 operations a
    half-spectrum value) and the elementwise and objective work (about 20
    a pixel)."""
    half = M * (N // 2 + 1)
    return prox_work(1, M, N, sweeps, duals_io=True)[0] + 2 * transform_work(1, M, N) \
        + 10 * half + 20 * M * N
