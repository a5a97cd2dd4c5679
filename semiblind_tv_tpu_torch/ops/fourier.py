"""Fourier-domain circular blur operator on the rfft2 half-spectrum (port of
`semiblind_tv_tpu/ops/fourier.py`, fft mode).

The reference embeds the s x s PSF into the top-left corner of an
image-sized array (`utils/resize.m`, no circular centering — the blur
carries a (s-1)/2-pixel translation, reproduced for parity) and applies the
blur as an FFT-diagonal multiply.  As in the JAX package:

  * images are real, so everything lives on the rfft2 grid (M, N//2 + 1);
  * the OTF of the (changing) PSF is two small complex matmuls
    H = Fxᵀ K Fy instead of a padded FFT; they run on `torch.matmul` in full
    precision (callers keep TF32 off — the counterpart of the JAX package's
    `Precision.HIGHEST`);
  * inner products use Parseval's theorem on the half-spectrum.

The transforms are `torch.fft` (cuFFT on the card).  The JAX package's TPU
workarounds — the dense-DFT transform mode, bf16 "high" precision and the
batched-FFT chunking — are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "dft_factors",
    "otf_rfft",
    "rfft_weights",
    "parseval_dot",
    "parseval_norm_sq",
    "BlurOperator",
]


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def dft_factors(size: int, shape, dtype=torch.complex64, device=None):
    """Fourier factor matrices (Fx, Fy) for the corner-embedded DFT:

    Fx[i, m] = exp(-2πi·i·m / M) for i in [0, s), m in [0, M)
    Fy[j, n] = exp(-2πi·j·n / N) for j in [0, s), n in [0, N//2]

    Phases are accumulated in float64 on the host, then cast.
    """
    M, N = shape
    i = np.arange(size)
    ang_x = (-2.0 * np.pi / M) * np.outer(i, np.arange(M))
    ang_y = (-2.0 * np.pi / N) * np.outer(i, np.arange(N // 2 + 1))
    np_dtype = np.complex128 if dtype == torch.complex128 else np.complex64
    Fx = torch.from_numpy(np.exp(1j * ang_x).astype(np_dtype)).to(device)
    Fy = torch.from_numpy(np.exp(1j * ang_y).astype(np_dtype)).to(device)
    return Fx, Fy


def otf_rfft(kernel: torch.Tensor, shape, factors=None) -> torch.Tensor:
    """Half-spectrum OTF of the corner-embedded kernel via two small matmuls;
    equals fft2(corner-padded kernel)[:, :N//2+1]."""
    s = kernel.shape[-1]
    if factors is None:
        factors = dft_factors(s, shape, _complex_of(kernel.dtype), kernel.device)
    Fx, Fy = factors
    k = kernel.to(Fx.dtype)
    return torch.matmul(torch.matmul(Fx.T, k), Fy)


def rfft_weights(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """Multiplicity weights (1, N//2+1) of the rfft2 columns for
    full-spectrum sums: 1 for column 0 and (N even) column N/2, else 2."""
    _, N = shape
    w = 2.0 * torch.ones((N // 2 + 1,), dtype=dtype, device=device)
    w[0] = 1.0
    if N % 2 == 0:
        w[-1] = 1.0
    return w[None, :]


def parseval_dot(ahat, bhat, weights, dim):
    """sum(a * b) over the spatial domain for real a, b given on the rfft grid."""
    return torch.sum(weights * (ahat * torch.conj(bhat)).real) / dim


def parseval_norm_sq(ahat, weights, dim):
    """||a||_F^2 for a real field given on the rfft grid."""
    re, im = ahat.real, ahat.imag
    return torch.sum(weights * (re * re + im * im)) / dim


class BlurOperator:
    """Circular convolution A (and Aᵀ) as an rfft-diagonal multiply.

    Holds the cached DFT factor matrices and Parseval weights on `device`;
    the OTF is passed in (it changes every SAPG step)."""

    def __init__(self, shape, psf_size: int, dtype=torch.float32, device=None):
        self.shape = tuple(int(s) for s in shape)
        self.psf_size = int(psf_size)
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.cdtype = _complex_of(dtype)
        self.factors = dft_factors(psf_size, self.shape, self.cdtype, self.device)
        self.weights = rfft_weights(self.shape, dtype, self.device)
        self.dim = self.shape[0] * self.shape[1]

    def otf(self, kernel: torch.Tensor) -> torch.Tensor:
        return otf_rfft(kernel, self.shape, self.factors)

    def otf_batched(self, kernels: torch.Tensor) -> torch.Tensor:
        """OTFs of a stack of kernels (B, s, s) -> (B, M, N//2+1) in one
        batched complex matmul pair (the PSF and its parameter gradients)."""
        Fx, Fy = self.factors
        k = kernels.to(Fx.dtype)
        left = torch.einsum("sm,bst->bmt", Fx, k)
        return torch.einsum("bmt,tn->bmn", left, Fy)

    def otf_host(self, kernel) -> torch.Tensor:
        """OTF accumulated in float64 on the host, cast to the working complex
        type and placed on the device (the JAX package's host-side OTF for
        loop constants; kept so the two packages round alike)."""
        Fx, Fy = (f.cpu().numpy().astype(np.complex128) for f in self.factors)
        k = np.asarray(torch.as_tensor(kernel).detach().cpu().numpy(), np.complex128)
        H = (Fx.T @ k) @ Fy
        return torch.from_numpy(H).to(device=self.device, dtype=self.cdtype)

    def rfft_host(self, x) -> torch.Tensor:
        """rfft2 in float64 on the host, cast and placed on the device."""
        xn = np.asarray(torch.as_tensor(x).detach().cpu().numpy())
        return torch.from_numpy(np.fft.rfft2(xn)).to(device=self.device, dtype=self.cdtype)

    def rfft(self, x: torch.Tensor) -> torch.Tensor:
        return torch.fft.rfft2(x)

    def irfft(self, xhat: torch.Tensor) -> torch.Tensor:
        return torch.fft.irfft2(xhat, s=self.shape).to(self.dtype)

    def apply(self, x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """A x = irfft2(H ∘ rfft2(x))."""
        return self.irfft(H * self.rfft(x))

    def apply_adjoint(self, x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """Aᵀ x = irfft2(conj(H) ∘ rfft2(x))."""
        return self.irfft(torch.conj(H) * self.rfft(x))
