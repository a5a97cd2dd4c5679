"""The port's binding of the C++ float64 oracle (semiblind_tv_tpu_torch/native.py)
against the JAX package's binding (semiblind_tv_tpu/native) and against the
port's own float64 prox and TV norm (ops/tv_cuda.chambolle_prox_plain,
ops/tv.tv_norm), at 32² and 48×40.

The library `native/libsemiblind_native.so` is committed, so nothing here
skips: a library that cannot be built or loaded fails the tests.  Bounds:
the two bindings call one library on the same arrays, so they agree to the
bit; the oracle against the port's prox within 1e-12 (f, the duals) with
equal sweep counts, and the TV within 1e-12 relative (sums in another
order).
"""
import numpy as np
import pytest
import torch

from semiblind_tv_tpu import native as jnative
from semiblind_tv_tpu_torch import native
from semiblind_tv_tpu_torch.ops.tv import tv_norm
from semiblind_tv_tpu_torch.ops.tv_cuda import chambolle_prox_plain

SHAPES = [(32, 32), (48, 40)]


def _image(shape, seed=0):
    return 10.0 * np.random.default_rng(seed).standard_normal(shape)


def test_library_builds_and_loads():
    assert native.available(), native.LIB_PATH
    assert native.LIB_PATH.endswith("native/libsemiblind_native.so")


@pytest.mark.parametrize("shape", SHAPES)
def test_tv_norm_matches_jax_binding_and_port(shape):
    x = _image(shape, 1)
    got = native.tv_norm_native(x)
    assert got == jnative.tv_norm_native(x)
    assert native.tv_norm_native(torch.from_numpy(x)) == got
    np.testing.assert_allclose(got, float(tv_norm(torch.from_numpy(x))), rtol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lam,iters,tol", [(0.5, 25, 1e-3), (5.0, 10, 0.0), (20.0, 25, 5.0)])
def test_chambolle_prox_matches_jax_binding_and_port(shape, lam, iters, tol):
    g = _image(shape, 2)
    f, px, py, k, err = native.chambolle_prox_native(g, lam, iters, tol=tol)
    jf, jpx, jpy, jk, jerr = jnative.chambolle_prox_native(g, lam, iters, tol=tol)
    for a, b in ((f, jf), (px, jpx), (py, jpy)):
        np.testing.assert_array_equal(a, b)
    assert (k, err) == (jk, jerr)
    pf, st = chambolle_prox_plain(torch.from_numpy(g), lam, iters, tol=tol)
    for a, b in ((f, pf), (px, st.px), (py, st.py)):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-12, atol=1e-12)
    assert k == int(st.iters)
    np.testing.assert_allclose(err, float(st.err), rtol=1e-10)
    if tol == 5.0:
        assert k < iters   # the exit fired


@pytest.mark.parametrize("shape", SHAPES)
def test_chambolle_prox_warm_duals_and_tensors(shape):
    g = _image(shape, 3)
    _, px, py, _, _ = native.chambolle_prox_native(g, 1.0, 10)
    f, qx, qy, k, _ = native.chambolle_prox_native(torch.from_numpy(g), 1.0, 10,
                                                   duals=(torch.from_numpy(px), py))
    assert torch.is_tensor(f) and f.dtype == torch.float64 and f.shape == shape
    jf = jnative.chambolle_prox_native(g, 1.0, 10, duals=(px, py))[0]
    np.testing.assert_array_equal(f.numpy(), jf)
    pf, st = chambolle_prox_plain(torch.from_numpy(g), 1.0, 10,
                                  duals=(torch.from_numpy(px), torch.from_numpy(py)))
    np.testing.assert_allclose(f.numpy(), pf.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(qx.numpy(), st.px.numpy(), rtol=1e-12, atol=1e-12)
    assert k == int(st.iters)


def test_inputs_the_oracle_refuses():
    with pytest.raises(ValueError):
        native.tv_norm_native(np.zeros((2, 3, 4)))
    with pytest.raises(ValueError):
        native.chambolle_prox_native(torch.zeros((4, 4), device="meta"), 1.0, 5)
