"""The demos' PSF families, by name, and the OTF.

A family is a file of its own, `portbench/reference/psfs/<name>.py`, found
by the configuration's `psf`: it names its parameters (`PARAMS`) and gives
`kernel(size, params, demo, dtype, device)`, the unnormalised kernel and its
gradients in those parameters, on the centred grid of `grid`.  Kernels are
normalised here to sum to one, gradients by the quotient rule.  The OTF is
the half-spectrum rfft2 of the kernel placed in the top-left corner of an
image-sized field (utils/resize.m, no centring).
"""
from __future__ import annotations

import functools
import importlib.util
import os

import torch

FAMILY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "psfs")


def grid(size, dtype, device):
    """(v, u): the rows' and the columns' offsets from the kernel's centre."""
    offs = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    return offs[:, None].expand(size, size), offs[None, :].expand(size, size)


@functools.lru_cache(maxsize=None)
def _family(directory, name):
    path = os.path.join(directory, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no PSF family {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_psf_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(name):
    """The PSF family `name` (its file under FAMILY_DIR)."""
    return _family(FAMILY_DIR, name)


def kernel_and_grads(demo, params, dtype, device):
    """The demo's PSF at params {name: 0-d tensor}: (kernel, {name: dk})."""
    fam = family(demo["psf"])
    f, dfs = fam.kernel(demo["psf_size"], params, demo, dtype, device)
    S = f.sum()
    return f / S, {n: (df * S - f * df.sum()) / (S * S) for n, df in zip(fam.PARAMS, dfs)}


def otf(kernels, shape):
    """Half-spectrum OTFs (..., M, N//2+1) of (..., s, s) corner-placed kernels."""
    s = kernels.shape[-1]
    field = kernels.new_zeros(kernels.shape[:-2] + tuple(shape))
    field[..., :s, :s] = kernels
    return torch.fft.rfft2(field)
