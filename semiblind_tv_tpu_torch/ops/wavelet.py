"""Translation-invariant (undecimated) Daubechies wavelet frames, Parseval-
tight (port of `semiblind_tv_tpu/ops/wavelet.py`).

The reference's Rice-Wavelet-Toolbox path (`SALSA/mrdwt_TI2D.m`,
`mirdwt_TI2D.m`, `daubcqf.m`) used by the wavelet-synthesis L1 experiment
(`SALSA/run_deblur_synthesis_L1.m:101-109`).  With an orthonormal CQF pair
(h, g) scaled by 1/√2 (the reference wrappers' 2^{-level} rescaling), the
à-trous analysis at level l correlates circularly with the filters dilated
by s = 2^l; HᵀH + GᵀG = I per axis, so analysisᵀ ∘ analysis = I exactly and
synthesis is the adjoint (the W Wᵀ = I that the wavelet-L1 SALSA solve's
Sherman–Morrison step needs).

Layout is the reference's column-concatenated format (mrdwt_TI2D.m:23):
analysis of an (m, n) image with L levels gives (m, n·(3L+1)) =
[lowpass, level-1 (lh, hl, hh), level-2 ...].  Every function acts on the
last two dimensions, so leading batch dimensions pass through.

The à-trous ladder is `torch.roll` with the JAX package's signs: the row
and column filters of one level run on a stacked (filter, ...) tensor, one
roll per tap, with the same products and sums in the same order as the
JAX package's per-band form.  `daubcqf` is numpy, copied.
"""
from __future__ import annotations

import functools
from math import comb

import numpy as np
import torch

__all__ = [
    "daubcqf",
    "ti_analysis",
    "ti_synthesis",
    "ti_haar_analysis",
    "ti_haar_synthesis",
    "uniform_blur_kernel",
]


def daubcqf(N: int, phase: str = "min"):
    """Daubechies length-N orthonormal CQF pair (h0 scaling, h1 wavelet),
    the capability of `SALSA/daubcqf.m:1-106` ('min'/'max'/'mid' phases) by
    the standard spectral factorisation:

      h0(z) ∝ ((1+z)/2)^K · Q(z),  K = N/2, where Q collects, for each root
      y_j of P(y) = Σ_{k<K} C(K−1+k, k) y^k, one z-root of
      z² − (2−4y_j)z + 1 = 0 per reciprocal pair: the one inside the unit
      circle (minimum phase) by default.  'mid' takes the reference's mixed
      in/out selection over the magnitude-sorted roots (daubcqf.m:92-98);
      'max' reverses the min-phase filter.  Σ h0 = √2 (‖h0‖₂ = 1);
      h1[k] = (−1)^k h0[N−1−k] (daubcqf.m:103-104).

    >>> daubcqf(4)[0]   # daubcqf.m:20-24
    array([ 0.48296291,  0.8365163 ,  0.22414387, -0.12940952])
    """
    if N % 2 != 0 or N < 2:
        raise ValueError("Daubechies filters require even N >= 2")
    if phase not in ("min", "max", "mid"):
        raise ValueError(f"phase must be 'min', 'max' or 'mid', got {phase!r}")
    K = N // 2
    P = np.array([comb(K - 1 + k, k) for k in range(K)], dtype=np.float64)
    zroots = []
    if K > 1:
        pairs = []
        for y in np.roots(P[::-1]):
            b = 2.0 - 4.0 * y
            disc = np.sqrt(b * b - 4.0 + 0j)
            pairs.extend([(b + disc) / 2.0, (b - disc) / 2.0])
        if phase == "mid" and K > 2:
            # MATLAB sorts complex by |z| then angle (daubcqf.m:91-98)
            q = sorted(pairs, key=lambda z: (abs(z), np.angle(z)))
            if K % 2 == 1:
                idx = list(range(0, N - 2, 4)) + list(range(1, N - 2, 4))
            else:
                idx = (
                    [0]
                    + list(range(3, K - 1, 4))
                    + list(range(4, K - 1, 4))
                    + list(range(N - 4, K - 2, -4))
                    + list(range(N - 5, K - 2, -4))
                )
            zroots = [q[i] for i in idx]
        else:
            zroots = [z for z in pairs if abs(z) <= 1.0]
    h0 = np.array([1.0])
    for _ in range(K):
        h0 = np.convolve(h0, [1.0, 1.0])
    if zroots:
        h0 = np.convolve(h0, np.real(np.poly(np.array(zroots))))
    h0 = np.sqrt(2.0) * h0 / h0.sum()
    if abs(np.sum(h0 ** 2) - 1.0) > 1e-4:
        raise ValueError(f"daubcqf numerically unstable for N={N}")
    if phase == "max":
        h0 = h0[::-1].copy()
    h1 = h0[::-1].copy()
    h1[::2] *= -1.0
    return h0, h1


def _filters(wavelet_order: int, x: torch.Tensor) -> torch.Tensor:
    """(2, T) analysis taps [h; g], scaled by 1/√2 for a tight frame and
    rounded to x's dtype (as the JAX package rounds them), on x's device,
    shaped (2, T, 1, ..., 1) to broadcast over x's dimensions."""
    return _taps(wavelet_order, x.dtype, x.device, x.ndim)


@functools.lru_cache(maxsize=None)
def _taps(wavelet_order: int, dtype, device, ndim: int) -> torch.Tensor:
    # cached: a host-to-device copy in every transform would stall the
    # host on the device once a call
    h0, h1 = daubcqf(wavelet_order)
    s = 1.0 / np.sqrt(2.0)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    taps = np.stack([h0 * s, h1 * s]).astype(np_dtype)
    return torch.from_numpy(taps).to(device).reshape(taps.shape + (1,) * ndim)


def _filt(a: torch.Tensor, taps: torch.Tensor, s: int, dim: int, sign: int) -> torch.Tensor:
    """Both filters at once on (..., M, N): out[f] = Σ_k taps[f, k]·roll(a,
    sign·s·k) — sign −1 is the à-trous correlation (F a)[i] = Σ_k t[k]
    a[i + s·k], sign +1 its adjoint; summed tap by tap as the JAX package
    sums them."""
    out = taps[:, 0] * a
    for k in range(1, taps.shape[1]):
        out = out + taps[:, k] * torch.roll(a, sign * s * k, dims=dim)
    return out


def ti_analysis(x: torch.Tensor, levels: int, wavelet_order: int = 2) -> torch.Tensor:
    """Undecimated analysis (the reference's WT = mrdwt_TI2D with
    daubcqf(wavelet_order) filters): (..., m, n) -> (..., m, n(3L+1))."""
    taps = _filters(wavelet_order, x)
    details = []
    ll = x
    for l in range(levels):
        s = 2 ** l
        r = _filt(ll, taps, s, -2, -1)            # rows: [lo_r, hi_r]
        c = _filt(r, taps[..., None], s, -1, -1)  # columns: c[f, r]
        ll = c[0, 0]
        details.append(torch.cat([c[1, 0], c[0, 1], c[1, 1]], dim=-1))  # lh, hl, hh
    return torch.cat([ll] + details, dim=-1)


def ti_synthesis(z: torch.Tensor, levels: int, wavelet_order: int = 2) -> torch.Tensor:
    """Undecimated synthesis (the reference's W = mirdwt_TI2D) = analysisᵀ:
    (..., m, n(3L+1)) -> (..., m, n).  Tight frame: W(WT(x)) = x."""
    n = z.shape[-1] // (3 * levels + 1)
    ll = z[..., :n]
    taps = _filters(wavelet_order, ll)
    for l in reversed(range(levels)):
        s = 2 ** l
        lh, hl, hh = z[..., n * (1 + 3 * l): n * (4 + 3 * l)].split(n, dim=-1)
        bands = torch.stack([torch.stack([ll, lh]), torch.stack([hl, hh])])  # [r, f]
        c = _filt(bands, taps, s, -1, 1)   # column filter f on band [r, f]
        c = _filt(c[:, 0] + c[:, 1], taps, s, -2, 1)  # row filter r on [lo_r, hi_r]
        ll = c[0] + c[1]
    return ll


def ti_haar_analysis(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Haar (order-2) analysis — the run_deblur_synthesis_L1 configuration."""
    return ti_analysis(x, levels, wavelet_order=2)


def ti_haar_synthesis(z: torch.Tensor, levels: int) -> torch.Tensor:
    """Haar (order-2) synthesis = analysisᵀ."""
    return ti_synthesis(z, levels, wavelet_order=2)


def uniform_blur_kernel(size: int, blur_length: int) -> np.ndarray:
    """Centred 2-D uniform (boxcar) blur kernel as a full (size, size) image
    for fft2 — reference SALSA/uniform_blur.m:1-16 (this path centres the
    kernel circularly via cshift)."""
    h = np.zeros(size)
    h[:blur_length] = 1.0 / blur_length
    h = np.roll(h, -(blur_length - 1) // 2)
    return np.outer(h, h)
