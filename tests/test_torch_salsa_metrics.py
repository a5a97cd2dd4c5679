"""Port vs JAX package: the SALSA MAP solver and the image metrics.

float64 inputs from a numpy seed into both packages.  SALSA's iterates and
traces agree to 1e-8 relative (a 1e-16 rounding difference grows over the
outer iterations); the metrics agree to 1e-12, except SSIM, which both
packages compute in float32 (see test_ssim_matches_jax).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu import metrics as jm
from semiblind_tv_tpu.ops.fourier import BlurOperator as JBlur
from semiblind_tv_tpu.solvers.salsa import salsa_tv as j_salsa_tv
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.metrics import metrics as tm
from semiblind_tv_tpu_torch.ops.fourier import BlurOperator as TBlur
from semiblind_tv_tpu_torch.ops.psf import gaussian_kernel
from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv, soft_threshold
from tests import oracles

SIZE = 32
RTOL = 1e-8


def _problem(seed=0):
    x = synthetic_wheel(SIZE)
    k = gaussian_kernel(7, 0.4, 0.3, dtype=torch.float64).numpy()
    H_full = oracles.np_otf(k, x.shape)
    y = oracles.np_blur(x, H_full) + 3.0 * np.random.default_rng(seed).standard_normal(x.shape)
    return x, y, k, H_full


@pytest.mark.parametrize("stop_criterion,tol,max_iter", [
    (1, 1e-5, 60),
    (2, 1e-3, 60),
    (3, 1e4, 40),
])
def test_salsa_matches_jax(stop_criterion, tol, max_iter):
    x, y, k, _ = _problem()
    tb = TBlur(x.shape, 7, torch.float64)
    jb = JBlur(x.shape, 7, jnp.float64)
    H = tb.otf(torch.from_numpy(k)).numpy()
    kw = dict(tau=0.5, mu=0.05, max_iter=max_iter, tol=tol, stop_criterion=stop_criterion)
    jr = j_salsa_tv(jnp.asarray(y), H, blur=jb, x_true=jnp.asarray(x), use_pallas=False, **kw)
    tr = salsa_tv(y, torch.from_numpy(H), blur=tb, x_true=x, **kw)
    assert tr.n_iters == jr.n_iters
    assert tr.op_counts == jr.op_counts
    np.testing.assert_allclose(tr.x, np.asarray(jr.x), rtol=RTOL, atol=1e-8)
    for name in ("objective", "distance", "mses", "criterion"):
        a, b = getattr(tr, name), np.asarray(getattr(jr, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12, err_msg=name)


def test_salsa_early_stop_fills_frozen_tail_like_jax():
    """Criterion 1 fires well before max_iter: the port leaves its loop at
    the next host check, and the frozen tail of the traces must still equal
    the JAX package's full-length frozen scan."""
    x, y, k, _ = _problem(1)
    tb = TBlur(x.shape, 7, torch.float64)
    H = tb.otf(torch.from_numpy(k)).numpy()
    kw = dict(tau=0.5, mu=0.05, max_iter=200, tol=1e-3)
    jr = j_salsa_tv(jnp.asarray(y), H, blur=JBlur(x.shape, 7, jnp.float64),
                    x_true=jnp.asarray(x), use_pallas=False, **kw)
    tr = salsa_tv(y, torch.from_numpy(H), blur=tb, x_true=x, **kw)
    assert tr.n_iters == jr.n_iters < 100
    for name in ("objective", "distance", "mses", "criterion"):
        np.testing.assert_allclose(getattr(tr, name), np.asarray(getattr(jr, name)),
                                   rtol=RTOL, atol=1e-12, err_msg=name)


def test_salsa_matches_numpy_oracle():
    x, y, k, H_full = _problem(2)
    tb = TBlur(x.shape, 7, torch.float64)
    H = tb.otf(torch.from_numpy(k))
    tr = salsa_tv(y, H, tau=0.5, mu=0.05, blur=tb, max_iter=80, tol=1e-5, x_true=x)
    orc = oracles.np_salsa(y, H_full, 0.5, 0.05, 80, tol=1e-5, x_true=x)
    assert tr.n_iters == orc["n_iters"]
    np.testing.assert_allclose(tr.x, orc["x"], rtol=1e-7, atol=1e-7)
    n = tr.n_iters
    np.testing.assert_allclose(tr.objective[: n + 1], orc["objective"], rtol=1e-8)
    np.testing.assert_allclose(tr.mses[: n + 1], orc["mses"], rtol=1e-8)
    np.testing.assert_allclose(tr.distance[:n], orc["distance"], rtol=1e-7)
    np.testing.assert_allclose(tr.criterion[1:n], orc["criterion"], rtol=1e-6)


def test_soft_threshold():
    v = torch.linspace(-3, 3, 13, dtype=torch.float64)
    np.testing.assert_allclose(soft_threshold(v, 1.0).numpy(),
                               np.sign(v.numpy()) * np.maximum(np.abs(v.numpy()) - 1.0, 0))
    np.testing.assert_array_equal(soft_threshold(v, 0.0).numpy(), v.numpy())


def test_scalar_metrics_match_jax():
    rng = np.random.default_rng(3)
    x = rng.random((SIZE, SIZE)) * 255
    y = x + rng.standard_normal(x.shape) * 7
    tx, ty, jx, jy = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    for name in ("mse_db", "psnr", "snr", "l2_spectral_sq"):
        np.testing.assert_allclose(float(getattr(tm, name)(tx, ty)),
                                   float(getattr(jm, name)(jx, jy)), rtol=1e-12, err_msg=name)


def test_ssim_matches_jax():
    """Both packages compute SSIM in float32 with L=1 on [0, 255] data
    (MATLAB's default for doubles); the variances E[x²]−µ² then cancel to a
    few 1e-3 against c2 = 9e-4, so the two convolutions' summation orders
    alone move the result by up to ~1e-4 relative: tolerance 1e-3."""
    rng = np.random.default_rng(4)
    x = synthetic_wheel(SIZE)
    y = x + rng.standard_normal(x.shape) * 5
    np.testing.assert_allclose(float(tm.ssim(torch.from_numpy(x), torch.from_numpy(y))),
                               float(jm.ssim(jnp.asarray(x), jnp.asarray(y))), rtol=1e-3)
    np.testing.assert_allclose(float(tm.ssim(torch.from_numpy(x), torch.from_numpy(x))), 1.0,
                               rtol=1e-6)
    # conventional dynamic range: well conditioned, float32 precision
    np.testing.assert_allclose(
        float(tm.ssim(torch.from_numpy(x), torch.from_numpy(y), dynamic_range=255.0)),
        float(jm.ssim(jnp.asarray(x), jnp.asarray(y), dynamic_range=255.0)), rtol=1e-5,
    )
