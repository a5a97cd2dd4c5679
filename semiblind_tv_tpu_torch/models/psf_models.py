"""PSF model families as parametric objects (port of
`semiblind_tv_tpu/models/psf_models.py`).

One generic SAPG estimator consumes a `PsfModel` (kernel + analytic
parameter gradients over a dict of scalar parameters) and the per-parameter
SA policy of each `ParamSpec`.  The isotropic family is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from semiblind_tv_tpu_torch.ops import psf as psf_ops

__all__ = ["ParamSpec", "PsfModel", "GaussianPsfModel", "LaplacePsfModel", "MoffatPsfModel"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Stochastic-approximation policy for one scalar hyperparameter: step
    scale, projection box, fix flag and the sign of the SA update (+1 ascent
    for θ/σ², −1 descent for the PSF parameters —
    SAPG_algorithm_Guassian.m:166,174,183,192)."""

    name: str
    init: float
    box: Tuple[float, float]
    step_scale: float
    sign: float = -1.0
    fix: bool = False
    true_value: Optional[float] = None

    def clip(self, value):
        """Project onto the box; a tensor stays on its device (no host sync)."""
        return torch.clamp(torch.as_tensor(value), self.box[0], self.box[1])


class PsfModel:
    """Base class: a parametric PSF family over a dict of scalar params.
    Kernels land on the device of the parameter tensors."""

    name: str = "base"
    param_names: Tuple[str, ...] = ()

    def __init__(self, size: int, dtype=torch.float32):
        self.size = int(size)
        self.dtype = dtype

    def kernel(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def kernel_and_grads(
        self, params: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError


class GaussianPsfModel(PsfModel):
    """Anisotropic rotated Gaussian with unknown bandwidths (w1, w2)."""

    name = "gaussian"
    param_names = ("w1", "w2")

    def __init__(self, size: int, phi: float = 0.0, dtype=torch.float32):
        super().__init__(size, dtype)
        self.phi = phi

    def kernel(self, params):
        return psf_ops.gaussian_kernel(
            self.size, params["w1"], params["w2"], self.phi, self.dtype
        )

    def kernel_and_grads(self, params):
        k, dw1, dw2 = psf_ops.gaussian_kernel_grads(
            self.size, params["w1"], params["w2"], self.phi, self.dtype
        )
        return k, {"w1": dw1, "w2": dw2}


class LaplacePsfModel(PsfModel):
    """Laplace PSF with unknown scale b."""

    name = "laplace"
    param_names = ("b",)

    def kernel(self, params):
        return psf_ops.laplace_kernel(self.size, params["b"], self.dtype)

    def kernel_and_grads(self, params):
        k, db = psf_ops.laplace_kernel_grads(self.size, params["b"], self.dtype)
        return k, {"b": db}


class MoffatPsfModel(PsfModel):
    """Moffat PSF with unknown (alpha, beta)."""

    name = "moffat"
    param_names = ("alpha", "beta")

    def kernel(self, params):
        return psf_ops.moffat_kernel(
            self.size, params["alpha"], params["beta"], self.dtype
        )

    def kernel_and_grads(self, params):
        k, da, db = psf_ops.moffat_kernel_grads(
            self.size, params["alpha"], params["beta"], self.dtype
        )
        return k, {"alpha": da, "beta": db}
