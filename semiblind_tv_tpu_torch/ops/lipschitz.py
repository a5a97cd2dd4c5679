"""Operator-norm estimation for the blur operator AᵀA (port of
`semiblind_tv_tpu/ops/lipschitz.py`).

The reference runs a power iteration with a random start
(`utils/max_eigenval_Gaussian_Moffat.m:1-27`, `utils/max_eigenval_Laplace.m`):
x ← Aᵀ(A(x)); val = ‖x‖; stop when the relative change < tol.

For an FFT-diagonal operator the limit is available in closed form:
λ_max(AᵀA) = max |H|².  Both are here — the closed form is what the
package uses (exact, free), the power iteration exists for parity testing
and for operators without a known diagonalisation.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["power_iteration", "max_eigenval_closed_form"]


def max_eigenval_closed_form(H: torch.Tensor) -> torch.Tensor:
    """λ_max(AᵀA) = max |H|² for the rfft-diagonal blur operator."""
    re, im = H.real, H.imag
    return torch.max(re * re + im * im)


def power_iteration(
    apply_AtA,
    generator: Optional[torch.Generator],
    shape,
    tol: float = 1e-4,
    max_iter: int = 10_000,
    x0: Optional[torch.Tensor] = None,
    dtype=torch.float32,
):
    """Power method for λ_max(AᵀA) (parity with max_eigenval_*.m); returns
    (val, iters) with val a 0-d tensor.

    apply_AtA: callable x -> Aᵀ(A(x)).  The start is x0 as given (the tests
    feed the JAX package's normalised start), else standard normals of
    `dtype` drawn from `generator` on its device, normalised.  The JAX
    package's masked while_loop becomes a host loop with the same stop rule
    (k < max_iter and rel ≥ tol), so each iteration reads the relative
    change back to the host."""
    if x0 is None:
        x0 = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                         device=generator.device)
        x0 = x0 / torch.linalg.norm(x0)
    x = x0
    val = torch.ones((), dtype=x.dtype, device=x.device)
    rel = float("inf")
    k = 0
    while k < max_iter and rel >= tol:
        x = apply_AtA(x)
        val_new = torch.linalg.norm(x)
        rel = float(torch.abs(val_new - val) / val)
        x = x / val_new
        val = val_new
        k += 1
    return val, k
