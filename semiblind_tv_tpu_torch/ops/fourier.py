"""Fourier-domain circular blur operator on the rfft2 half-spectrum (port of
`semiblind_tv_tpu/ops/fourier.py`).

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

Two transform modes, as in the JAX package: 'fft' (`torch.fft`, cuFFT on
the card; the default) and 'dft', dense real DFT matmuls with the factor
matrices of `rdft_matrices` (`rfft2_matmul`, `irfft2_matmul`, on
`torch.matmul` in full precision).  The dft mode's matrices also feed the
whole-iteration step kernels D and E (ops/fused_dft_cuda.py).  The JAX
package's TPU workarounds — bf16 "high" transform precision and the
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
    "rdft_matrices",
    "rfft2_matmul",
    "irfft2_matmul",
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


def rdft_matrices(shape, dtype=torch.float32, device=None):
    """Real cos/sin factor matrices of the matmul rfft2/irfft2, built in
    float64 with numpy exactly as the JAX package builds them, then cast
    (so the two packages' matrices are bit-equal).  For shape (M, N),
    Nh = N//2+1:

      CN, SN   (N, Nh)  cos/sin(2π nk/N)          forward rows
      CM, SM   (M, M)   cos/sin(2π mk/M)          forward and inverse columns
      WCT, WST (Nh, N)  w_k cos/sin(2π nk/N)/N    inverse rows, with the rfft
                                                  column weights w_k folded in
    """
    M, N = shape
    Nh = N // 2 + 1
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    n = np.arange(N)[:, None]
    k = np.arange(Nh)[None, :]
    ang_n = (2.0 * np.pi / N) * (n * k)
    m = np.arange(M)[:, None]
    km = np.arange(M)[None, :]
    ang_m = (2.0 * np.pi / M) * (m * km)
    w = 2.0 * np.ones((Nh, 1))
    w[0, 0] = 1.0
    if N % 2 == 0:
        w[-1, 0] = 1.0
    mats = dict(
        CN=np.cos(ang_n),
        SN=np.sin(ang_n),
        CM=np.cos(ang_m),
        SM=np.sin(ang_m),
        WCT=w * np.cos(ang_n).T / N,
        WST=w * np.sin(ang_n).T / N,
    )
    # row-major copies: the kernels of ops/fused_dft_cuda.py take contiguous
    # matrices, and w·cos(·).T is laid out column-major by numpy
    return {name: torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype)).to(device)
            for name, a in mats.items()}


def rfft2_matmul(x: torch.Tensor, mats) -> torch.Tensor:
    """rfft2 of real x (..., M, N) by six real matmuls: rows with
    exp(−2πi nk/N) = CN − i·SN, then columns with the symmetric (M, M)
    factor."""
    CN, SN, CM, SM = mats["CN"], mats["SN"], mats["CM"], mats["SM"]
    yre = torch.matmul(x, CN)
    yim = -torch.matmul(x, SN)
    zre = torch.matmul(CM, yre) + torch.matmul(SM, yim)
    zim = torch.matmul(CM, yim) - torch.matmul(SM, yre)
    return torch.complex(zre, zim)


def irfft2_matmul(zhat: torch.Tensor, mats) -> torch.Tensor:
    """irfft2 of a half-spectrum (..., M, N//2+1) by six real matmuls:
    inverse columns with exp(+2πi mk/M) = CM + i·SM and 1/M, then the
    Hermitian-expanded inverse rows, whose weights WCT/WST carry the
    conjugate columns (the JAX package's irfft2_matmul docstring)."""
    CM, SM, WCT, WST = mats["CM"], mats["SM"], mats["WCT"], mats["WST"]
    M = CM.shape[0]
    zre, zim = zhat.real, zhat.imag
    yre = (torch.matmul(CM, zre) - torch.matmul(SM, zim)) / M
    yim = (torch.matmul(CM, zim) + torch.matmul(SM, zre)) / M
    return torch.matmul(yre, WCT) - torch.matmul(yim, WST)


class BlurOperator:
    """Circular convolution A (and Aᵀ) as an rfft-diagonal multiply.

    Holds the cached DFT factor matrices and Parseval weights on `device`,
    and in fft_mode='dft' the rdft_matrices (`rdft`) that its transforms
    use; the OTF is passed in (it changes every SAPG step)."""

    def __init__(self, shape, psf_size: int, dtype=torch.float32, device=None,
                 fft_mode: str = "fft"):
        self.shape = tuple(int(s) for s in shape)
        self.psf_size = int(psf_size)
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.cdtype = _complex_of(dtype)
        self.factors = dft_factors(psf_size, self.shape, self.cdtype, self.device)
        self.weights = rfft_weights(self.shape, dtype, self.device)
        self.dim = self.shape[0] * self.shape[1]
        if fft_mode not in ("fft", "dft"):
            raise ValueError(f"fft_mode must be 'fft' or 'dft', got {fft_mode!r}")
        self.fft_mode = fft_mode
        self.rdft = rdft_matrices(self.shape, dtype, self.device) if fft_mode == "dft" else None

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
        if self.fft_mode == "dft":
            return rfft2_matmul(x, self.rdft)
        return torch.fft.rfft2(x)

    def irfft(self, xhat: torch.Tensor) -> torch.Tensor:
        if self.fft_mode == "dft":
            return irfft2_matmul(xhat, self.rdft).to(self.dtype)
        return torch.fft.irfft2(xhat, s=self.shape).to(self.dtype)

    def apply(self, x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """A x = irfft2(H ∘ rfft2(x))."""
        return self.irfft(H * self.rfft(x))

    def apply_adjoint(self, x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """Aᵀ x = irfft2(conj(H) ∘ rfft2(x))."""
        return self.irfft(torch.conj(H) * self.rfft(x))
