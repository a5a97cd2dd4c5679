"""Port vs JAX package: configuration presets and the PSF families.

Inputs are fixed parameters; both packages run in float64 and agree to
1e-12 (single operations).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops import psf as jpsf
from semiblind_tv_tpu.runtime import config as jcfg
from semiblind_tv_tpu_torch.models.psf_models import ParamSpec
from semiblind_tv_tpu_torch.ops import psf as tpsf
from semiblind_tv_tpu_torch.runtime import config as tcfg
from tests import oracles

TOL = 1e-12


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name,kwargs", [
    ("gaussian", {}),
    ("gaussian", dict(fix_w1=False, fix_w2=False, fix_sigma=True)),
    ("laplace", {}),
    ("laplace", dict(fix_b=True)),
    ("moffat", {}),
    ("moffat", dict(fix_alpha=True, beta=4.0)),
    ("isotropic_gaussian", {}),
])
def test_presets_equal_field_by_field(name, kwargs):
    j = jcfg.preset(name, **kwargs)
    t = tcfg.preset(name, **kwargs)
    assert _asdict(j) == _asdict(t)
    assert j.true_psf_params() == t.true_psf_params()
    assert j.init_psf_params() == t.init_psf_params()
    assert j.sapg.burn_in_resolved == t.sapg.burn_in_resolved


def test_config_defaults_equal():
    for jc, tc in ((jcfg.SAPGConfig, tcfg.SAPGConfig), (jcfg.SALSAConfig, tcfg.SALSAConfig)):
        jf = {f.name: f.default for f in dataclasses.fields(jc)}
        tf = {f.name: f.default for f in dataclasses.fields(tc)}
        assert jf == tf


def test_paramspec_clip_stays_on_tensor():
    spec = ParamSpec("w", init=0.5, box=(0.1, 1.0), step_scale=1.0)
    v = torch.tensor([0.05, 0.5, 3.0], dtype=torch.float64)
    np.testing.assert_array_equal(spec.clip(v).numpy(), [0.1, 0.5, 1.0])
    assert torch.is_tensor(spec.clip(torch.tensor(2.0)))


def _t(*vals):
    return [torch.tensor(v, dtype=torch.float64) for v in vals]


@pytest.mark.parametrize("w1,w2,phi", [(0.4, 0.3, 0.0), (0.7, 0.2, 0.3)])
def test_gaussian_kernel_and_grads(w1, w2, phi):
    jk, j1, j2 = jpsf.gaussian_kernel_grads(7, w1, w2, phi, jnp.float64)
    tk, t1, t2 = tpsf.gaussian_kernel_grads(7, *_t(w1, w2), phi=phi, dtype=torch.float64)
    for a, b in ((jk, tk), (j1, t1), (j2, t2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL, atol=TOL)
    ok, o1, o2 = oracles.np_gaussian_kernel_grads(7, w1, w2, phi)
    np.testing.assert_allclose(tk.numpy(), ok, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t1.numpy(), o1, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tpsf.gaussian_kernel(7, *_t(w1, w2), phi=phi, dtype=torch.float64).numpy(),
        oracles.np_gaussian_kernel(7, w1, w2, phi), rtol=TOL, atol=TOL,
    )


def test_laplace_kernel_and_grad():
    jk, jd = jpsf.laplace_kernel_grads(7, 0.3, jnp.float64)
    tk, td = tpsf.laplace_kernel_grads(7, *_t(0.3), dtype=torch.float64)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)
    ok, od = oracles.np_laplace_kernel_grads(7, 0.3)
    np.testing.assert_allclose(td.numpy(), od, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tpsf.laplace_kernel(7, 0.3, dtype=torch.float64).numpy(),
        oracles.np_laplace_kernel(7, 0.3), rtol=TOL, atol=TOL,
    )


def test_moffat_kernel_and_grads_keep_alpha_quirk():
    jk, ja, jb = jpsf.moffat_kernel_grads(7, 0.4, 3.5, jnp.float64)
    tk, ta, tb = tpsf.moffat_kernel_grads(7, *_t(0.4, 3.5), dtype=torch.float64)
    for a, b in ((jk, tk), (ja, ta), (jb, tb)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL, atol=TOL)
    ok, oa, ob = oracles.np_moffat_kernel_grads(7, 0.4, 3.5)
    np.testing.assert_allclose(ta.numpy(), oa, rtol=TOL, atol=TOL)
    # the α gradient is the reference's formula, not the exact derivative;
    # the β gradient is exact (autograd through the kernel)
    a, b = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (0.4, 3.5))
    k = tpsf.moffat_kernel(7, a, b, dtype=torch.float64)
    exact_a = torch.autograd.grad(k[3, 5], a, retain_graph=True)[0]
    exact_b = torch.autograd.grad(k[3, 5], b)[0]
    np.testing.assert_allclose(float(tb[3, 5]), float(exact_b), rtol=1e-10)
    assert abs(float(ta[3, 5]) - float(exact_a)) > 1e-6


def test_psf_batched_parameters_give_kernel_stack():
    w1 = torch.tensor([0.3, 0.5, 0.9], dtype=torch.float64)
    ks = tpsf.gaussian_kernel(7, w1, 0.3, dtype=torch.float64)
    assert ks.shape == (3, 7, 7)
    for i in range(3):
        np.testing.assert_allclose(
            ks[i].numpy(), oracles.np_gaussian_kernel(7, float(w1[i]), 0.3), rtol=TOL, atol=TOL
        )


def test_gaussian_grads_match_autograd():
    w1, w2 = (torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (0.4, 0.3))
    k = tpsf.gaussian_kernel(7, w1, w2, dtype=torch.float64)
    _, d1, d2 = tpsf.gaussian_kernel_grads(7, 0.4, 0.3, dtype=torch.float64)
    g1, g2 = torch.autograd.grad(k[2, 4], (w1, w2))
    np.testing.assert_allclose(float(d1[2, 4]), float(g1), rtol=1e-10)
    np.testing.assert_allclose(float(d2[2, 4]), float(g2), rtol=1e-10)
