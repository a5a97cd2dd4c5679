"""Operator norm of AᵀA for the rfft-diagonal blur (port of
`semiblind_tv_tpu/ops/lipschitz.py`, closed form).

λ_max(AᵀA) = max |H|² — the limit of the reference's power iteration
(`utils/max_eigenval_Gaussian_Moffat.m`), exact and free for this operator.
The power iteration comes later with the rest of queue 1.
"""
from __future__ import annotations

import torch

__all__ = ["max_eigenval_closed_form"]


def max_eigenval_closed_form(H: torch.Tensor) -> torch.Tensor:
    """λ_max(AᵀA) = max |H|² for the rfft-diagonal blur operator."""
    re, im = H.real, H.imag
    return torch.max(re * re + im * im)
