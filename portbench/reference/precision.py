"""The arithmetic the reference runs in.

`exact` keeps every field in the dtype it is computed in (the reference).
`tf32` rounds every field the reference stores to TF32's 10-bit mantissa,
to nearest, ties away from zero: the control, the reference computed one
precision below the configuration's float32 (whose matrix products run with
TF32 off).
"""
from __future__ import annotations

import torch


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return torch.complex(tf32(t.real.contiguous()), tf32(t.imag.contiguous()))
    if t.dtype != torch.float32:
        raise TypeError(f"the TF32 control rounds float32 fields, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, ~0x1FFF).view(torch.float32)

