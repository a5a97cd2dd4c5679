"""The Gaussian PSF of utils/Gaussian_psf.m, k ∝ (w1·w2/2π)·exp(−(w1²U² +
w2²V²)/2) on the centred grid rotated by the configuration's φ, and its
gradients (diff_fftgaus_w1.m, diff_fftgaus_w2.m)."""
import math

import torch

from portbench.reference.psf import grid

PARAMS = ("w1", "w2")


def kernel(size, params, demo, dtype, device):
    """(k, [dk/dw1, dk/dw2]), unnormalised, for 0-d tensor parameters."""
    w1, w2 = params["w1"], params["w2"]
    v, u = grid(size, dtype, device)
    c, s = math.cos(demo["phi"]), math.sin(demo["phi"])
    U = u * c - v * s
    V = u * s + v * c
    e = torch.exp(-(w1 ** 2 * U ** 2 + w2 ** 2 * V ** 2) / 2.0)
    f = (w1 * w2) / (2.0 * math.pi) * e
    d1 = (w2 / (2.0 * math.pi)) * (1.0 - w1 ** 2 * U ** 2) * e
    d2 = (w1 / (2.0 * math.pi)) * (1.0 - w2 ** 2 * V ** 2) * e
    return f, [d1, d2]
