"""Test-signal generators and operator-shape helpers (port of
`semiblind_tv_tpu/utils/signals.py`, the reference's `SALSA/` legacy).

  * `calctv`        — TV + max-gradient-magnitude of an image
                      (SALSA/calctv.m:1-7: zero-padded forward differences,
                      not the circular differences of TVnorm).
  * `monotonize`    — cumulative-offset monotone envelope of a 1-D trace
                      (SALSA/monotonize.m:1-16).
  * `sparse_pws`    — L random n×n unit squares on an N×N canvas
                      (SALSA/sparsePWS.m:1-9).
  * `make_rd_squares` — NESTA's random-dynamic-range squares phantom
                      (SALSA/MakeRDSquares.m:1-31).
  * `vectorized_operator` — flatten/reshape adapter exposing an image-space
                      (A, Aᵀ) pair as one mode-switched map on flat vectors
                      (SALSA/A_wrapper.m:1-18).
  * `ensure`        — assertion helper (SALSA/ensure.m:29-39).

The random generators take an explicit `torch.Generator` (their draws land
on its device) instead of MATLAB's global `rand` stream; `corners=` and
`draws=` pin the geometry.  Flat vectors are column-major, as in MATLAB.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = [
    "calctv",
    "monotonize",
    "sparse_pws",
    "make_rd_squares",
    "vectorized_operator",
    "ensure",
]


def calctv(x: torch.Tensor, shape: Optional[Tuple[int, int]] = None):
    """(tv, max |∇|) with zero-padded forward differences (SALSA/calctv.m:4-6).

    `x` is an (N1, N2) image, or a flat vector with `shape` (reshaped
    column-major, as MATLAB does, so round trips with `vectorized_operator`
    agree)."""
    x = torch.as_tensor(x)
    if x.ndim == 1:
        if shape is None:
            raise ValueError("flat input requires shape=(N1, N2)")
        n1, n2 = shape
        X = x.reshape((n2, n1)).T
    else:
        X = x
    dh = torch.nn.functional.pad(torch.diff(X, dim=1), (0, 1))  # [diff(X,1,2) zeros]
    dv = torch.nn.functional.pad(torch.diff(X, dim=0), (0, 0, 0, 1))  # [diff(X,1,1); zeros]
    mag = torch.sqrt(dh ** 2 + dv ** 2)
    return torch.sum(mag), torch.max(mag)


def monotonize(x) -> torch.Tensor:
    """Non-decreasing envelope: y[k] = x[k] + Σ_{j≤k} max(0, x[j-1] − x[j])
    (the closed form of SALSA/monotonize.m:8-16's loop)."""
    x = torch.as_tensor(x)
    drops = torch.clamp(-torch.diff(x), min=0.0)
    return x + torch.cat([torch.zeros((1,), dtype=x.dtype, device=x.device),
                          torch.cumsum(drops, dim=0)])


def sparse_pws(generator: Optional[torch.Generator], N: int, L: int, n: int, corners=None,
               dtype=torch.float32) -> torch.Tensor:
    """L random n×n unit squares on an N×N zero canvas (SALSA/sparsePWS.m:3-8).

    Corners are MATLAB's `round(rand*N)` (0..N, clamped into the canvas
    with MATLAB's 1-based max(xc, 1)); overlapping squares overwrite with
    1.  `corners` (L, 2) pins the geometry."""
    if corners is None:
        device = generator.device if generator is not None else None
        u = torch.rand((L, 2), generator=generator, dtype=torch.float32, device=device)
        corners = torch.round(u * N).to(torch.int64)
    else:
        corners = torch.as_tensor(corners).to(torch.int64)
    rows = torch.arange(N, device=corners.device)
    canvas = torch.zeros((N, N), dtype=dtype, device=corners.device)
    for xc in corners:
        r0 = torch.clamp(xc[0], min=1) - 1   # MATLAB 1-based max(xc, 1)
        c0 = torch.clamp(xc[1], min=1) - 1
        rmask = (rows >= r0) & (rows <= torch.clamp(xc[0] + n - 1, max=N) - 1)
        cmask = (rows >= c0) & (rows <= torch.clamp(xc[1] + n - 1, max=N) - 1)
        canvas = torch.where(rmask[:, None] & cmask[None, :], 1.0, canvas)
    return canvas


def make_rd_squares(generator: Optional[torch.Generator], N: int = 256, nbs: int = 5,
                    dyna: float = 40.0, draws=None, dtype=torch.float32) -> torch.Tensor:
    """Random rectangles spanning `dyna` dB of amplitude
    (SALSA/MakeRDSquares.m:17-31): nbs rectangles with side lengths in
    [8, N/4] and amplitudes 1 + 10^(dyna/20)·u, then the support (> 0.5)
    shifted and rescaled to exactly [1, 10^(dyna/20)].  `draws` (nbs, 5)
    pins the uniforms."""
    lmin, lmax = 8, N // 4
    if draws is None:
        device = generator.device if generator is not None else None
        draws = torch.rand((nbs, 5), generator=generator, dtype=dtype, device=device)
    else:
        draws = torch.as_tensor(draws).to(dtype)
    rows = torch.arange(N, device=draws.device)
    canvas = torch.zeros((N, N), dtype=dtype, device=draws.device)
    for u in draws:
        ndx = 1 + torch.floor((N - lmax - 1) * u[0])
        lx = torch.clamp(torch.floor(lmin + (lmax - lmin) * u[1]), max=N - ndx - 1)
        ndy = 1 + torch.floor((N - lmax - 1) * u[2])
        ly = torch.clamp(torch.floor(lmin + (lmax - lmin) * u[3]), max=N - ndy - 1)
        amp = 1.0 + 10.0 ** (dyna / 20.0) * u[4]
        rmask = (rows >= ndx - 1) & (rows <= ndx + lx - 2)
        cmask = (rows >= ndy - 1) & (rows <= ndy + ly - 2)
        canvas = torch.where(rmask[:, None] & cmask[None, :], amp, canvas)
    supp = canvas > 0.5
    vmin = torch.min(torch.where(supp, canvas, torch.inf))
    shifted = torch.where(supp, canvas - vmin, 0.0)
    vmax = torch.max(shifted)
    scale = torch.where(vmax > 0, (10.0 ** (dyna / 20.0) - 1.0) / torch.clamp(vmax, min=1e-30),
                        0.0)
    return torch.where(supp, shifted * scale + 1.0, 0.0)


def vectorized_operator(A: Callable, AT: Callable, in_shape: Tuple[int, int],
                        out_shape: Tuple[int, int]) -> Callable:
    """Mode-switched flat-vector adapter for an image-space (A, Aᵀ) pair:
    `op(x, 1)` applies A: R^{M1·N1} → R^{M2·N2}, `op(x, 2)` applies Aᵀ
    (SALSA/A_wrapper.m:6-18), with column-major (MATLAB) flattening."""
    m1, n1 = in_shape
    m2, n2 = out_shape

    def op(x: torch.Tensor, mode: int) -> torch.Tensor:
        if mode == 1:
            return A(x.reshape((n1, m1)).T).T.reshape(m2 * n2)
        if mode == 2:
            return AT(x.reshape((n2, m2)).T).T.reshape(m1 * n1)
        raise ValueError("mode must be 1 (A) or 2 (AT)")

    return op


def ensure(condition, message: str = "Assertion failed") -> None:
    """Fail-fast precondition guard (SALSA/ensure.m:29-39)."""
    if not condition:
        raise AssertionError(message)
