"""The Moffat PSF of psf_moffat.m, k ∝ (α²/2π)·(1 + α²r²/β)^(−(β+2)/2), and
its gradients: diff_moffat_alpha.m (with its spurious factor 2 in the second
term's denominator, kept: the estimator follows that gradient) and
diff_moffat_beta.m."""
import math

import torch

from portbench.reference.psf import grid

PARAMS = ("alpha", "beta")


def kernel(size, params, demo, dtype, device):
    """(k, [dk/dα, dk/dβ]), unnormalised, for 0-d tensor parameters."""
    a, b = params["alpha"], params["beta"]
    v, u = grid(size, dtype, device)
    r2 = v * v + u * u
    base = r2 * a ** 2 / b + 1.0
    pw = base ** (-(b + 2.0) / 2.0)
    f = a ** 2 * pw / (2.0 * math.pi)
    da = (2.0 - ((b + 2.0) * r2 * a ** 2) / (2.0 * (b + r2 * a ** 2))) * pw * (a / (2.0 * math.pi))
    db = (-torch.log(base) + ((b + 2.0) * r2 * a ** 2) / (b * (b + r2 * a ** 2))) * pw \
        * (a ** 2 / (4.0 * math.pi))
    return f, [da, db]
