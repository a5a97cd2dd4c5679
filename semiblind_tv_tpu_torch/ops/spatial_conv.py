"""Spatial-domain circular convolution (port of
`semiblind_tv_tpu/ops/spatial_conv.py`).

The same operator as the corner-padded-OTF Fourier path (utils/resize.m
places the kernel at the top-left corner with no centring, which is plain
circular convolution with kernel index (0, 0) at the origin):

    (A x)[i,j]  = Σ_{a,b} k[a,b] · x[(i−a) mod M, (j−b) mod N]
    (Aᵀ x)[i,j] = Σ_{a,b} k[a,b] · x[(i+a) mod M, (j+b) mod N]

as wrap-padding plus a VALID `torch.nn.functional.conv2d` (cuDNN on the
card).  cuDNN convolutions default to TF32, which would put ~1e-3 of error
into A, so the call runs with cuDNN's TF32 off whatever the caller set —
the counterpart of the JAX package's Precision.HIGHEST.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["circ_conv", "circ_corr"]


@contextlib.contextmanager
def _cudnn_full_precision():
    """cuDNN's TF32 off inside, the caller's setting restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv_valid(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID cross-correlation of (B, Mp, Np) with (s, s)."""
    with _cudnn_full_precision():
        return F.conv2d(xp[:, None], k[None, None].to(xp.dtype))[:, 0]


def circ_conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Circular convolution ≡ BlurOperator.apply(x, otf(k)).

    x: (M, N) or (B, M, N); k: (s, s), s ≤ min(M, N), on x's device."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    p = k.shape[-1] - 1
    if p:
        x = torch.cat([x[:, -p:, :], x], dim=1)
        x = torch.cat([x[:, :, -p:], x], dim=2)
    out = _conv_valid(x, torch.flip(k, dims=(0, 1)))
    return out[0] if squeeze else out


def circ_corr(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Circular correlation ≡ BlurOperator.apply_adjoint(x, otf(k))."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    p = k.shape[-1] - 1
    if p:
        x = torch.cat([x, x[:, :p, :]], dim=1)
        x = torch.cat([x, x[:, :, :p]], dim=2)
    out = _conv_valid(x, k)
    return out[0] if squeeze else out
