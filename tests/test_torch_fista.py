"""Port vs JAX package: TV-FISTA (solvers/fista.py) and `run_demo
(solver="fista")`.

* `fista_tv` on the same 32² problem as tests/test_fista.py, float64: x
  within 1e-10 relative of JAX `fista_tv`, the objective trace within
  1e-10, the same n_iters, for each stop criterion and an early stop; and
  against the numpy oracle of tests/test_fista.py (my_deblur_fista.m) with
  that file's tolerances;
* the routes: A2, F and H forced on CPU tensors run their plain versions
  and give the plain route's result;
* `run_demo(solver="fista")` against JAX `run_demo(solver="fista")` with
  the JAX observation and chain noise injected (the tolerances of
  tests/test_torch_demo.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.cli.run_demo import run_demo as j_run_demo
from semiblind_tv_tpu.ops import fourier as jfourier
from semiblind_tv_tpu.ops import psf as jpsf
from semiblind_tv_tpu.runtime import config as jcfg
from semiblind_tv_tpu.solvers import fista_tv as j_fista_tv
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.cli import run_demo as t_cli
from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.solvers import FISTAResult, fista, fista_tv
from tests import oracles
from tests.test_fista import _np_fista_tv
from tests.test_torch_sapg import jax_chain_draws, replay

SHAPE = (32, 32)
RTOL = 1e-10


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    jblur = jfourier.BlurOperator(SHAPE, 7, jnp.float64)
    k = jpsf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64)
    H = jblur.otf(k)
    H_full = oracles.np_otf(np.asarray(k), SHAPE)
    x = np.kron(rng.random((8, 8)) * 50, np.ones((4, 4)))
    y = oracles.np_blur(x, H_full) + 0.3 * rng.standard_normal(SHAPE)
    tblur = BlurOperator(SHAPE, 7, torch.float64, "cpu")
    return jblur, tblur, np.array(H), H_full, x, y


@pytest.mark.parametrize("max_iter,tol,crit", [
    (40, 1e-12, 1),
    (300, 1e-6, 1),      # stops early: the frozen tail
    (60, 1e-4, 2),
    (25, 0.0, 3),
])
def test_fista_tv_matches_jax(max_iter, tol, crit):
    jblur, tblur, H, _, x, y = _problem()
    jr = j_fista_tv(jnp.asarray(y), H, tau=0.2, blur=jblur, tv_iters=10, max_iter=max_iter,
                    tol=tol, stop_criterion=crit, x_true=jnp.asarray(x))
    tr = fista_tv(torch.from_numpy(y), torch.from_numpy(H), tau=0.2, blur=tblur, tv_iters=10,
                  max_iter=max_iter, tol=tol, stop_criterion=crit, x_true=torch.from_numpy(x))
    assert isinstance(tr, FISTAResult)
    assert tr.n_iters == jr.n_iters
    np.testing.assert_allclose(tr.x, np.asarray(jr.x), rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(tr.objective, jr.objective, rtol=RTOL)
    np.testing.assert_allclose(tr.mses, jr.mses, rtol=RTOL)
    assert len(tr.objective) == max_iter + 1
    if max_iter == 300:
        assert tr.n_iters < 300 and tr.mses[tr.n_iters] < tr.mses[0]


def test_fista_tv_matches_the_oracle():
    _, tblur, H, H_full, _, y = _problem(1)
    res = fista_tv(torch.from_numpy(y), torch.from_numpy(H), tau=0.2, blur=tblur, tv_iters=10,
                   max_iter=40, tol=1e-12)
    ox, oobj = _np_fista_tv(y, H_full, 0.2, 1.0, 10, 40, 1e-12)
    np.testing.assert_allclose(res.x, ox, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(res.objective, oobj, rtol=1e-8)
    res = fista_tv(torch.from_numpy(y), torch.from_numpy(H), tau=0.2, blur=tblur, max_iter=300,
                   tol=1e-6)
    _, oobj = _np_fista_tv(y, H_full, 0.2, 1.0, 10, 300, 1e-6)
    assert res.n_iters == len(oobj) - 1


@pytest.mark.parametrize("route", ["A2", "F", "H"])
def test_forced_prox_routes_on_cpu_tensors_run_the_plain_versions(route):
    _, tblur, H, _, _, y = _problem()
    kw = dict(tau=0.2, blur=tblur, max_iter=30, tol=1e-9)
    plain = fista_tv(torch.from_numpy(y), torch.from_numpy(H), prox_route="plain", **kw)
    forced = fista_tv(torch.from_numpy(y), torch.from_numpy(H), prox_route=route, **kw)
    np.testing.assert_array_equal(forced.x, plain.x)
    assert forced.n_iters == plain.n_iters


def test_generic_fista_with_a_soft_threshold_prox_and_x0():
    """fista with another prox, L and x0 (my_fista.m's call shape)."""
    from semiblind_tv_tpu.solvers import fista as j_fista
    from semiblind_tv_tpu.solvers import soft_threshold as j_soft
    from semiblind_tv_tpu_torch.solvers import soft_threshold

    jblur, tblur, H, _, _, y = _problem(2)
    x0 = 0.5 * y
    jr = j_fista(jnp.asarray(y), H, 0.3, jblur, lambda v, s: j_soft(v, s),
                 lambda v: jnp.sum(jnp.abs(v)), L=1.5, max_iter=20, tol=1e-9,
                 x0=jnp.asarray(x0))
    tr = fista(torch.from_numpy(y), torch.from_numpy(H), 0.3, tblur,
               lambda v, s: soft_threshold(v, s), lambda v: torch.sum(torch.abs(v)), L=1.5,
               max_iter=20, tol=1e-9, x0=torch.from_numpy(x0))
    assert tr.n_iters == jr.n_iters
    np.testing.assert_allclose(tr.x, np.asarray(jr.x), rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(tr.objective, jr.objective, rtol=RTOL)


def test_bad_stop_criterion_raises():
    _, tblur, H, _, _, y = _problem()
    with pytest.raises(ValueError):
        fista_tv(torch.from_numpy(y), torch.from_numpy(H), 0.2, tblur, stop_criterion=4)


def test_run_demo_fista_matches_jax_run_demo():
    def short(cfg):
        return dataclasses.replace(
            cfg, sapg=dataclasses.replace(cfg.sapg, samples=40, warmup=20, burn_in=32),
            salsa=dataclasses.replace(cfg.salsa, outer_iters=50))

    jc = short(jcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    tc = short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    img = synthetic_wheel(32)
    jr, js, jsol, _ = j_run_demo(jc, img, dtype=jnp.float64, solver="fista")
    k_prob, k_sapg = jax.random.split(jax.random.key(jc.seed))
    obs = np.asarray(jax.random.normal(k_prob, img.shape, jnp.float64))
    draws = jax_chain_draws(k_sapg, 1, img.shape, (20 - 1) + (40 - 1))
    tr, ts, tsol, _ = t_cli.run_demo(tc, img, dtype=torch.float64, device="cpu",
                                     obs_noise=obs, noise=replay(draws), solver="fista")
    for k in ("theta_EB", "sigma2_EB", "mse_db", "psnr_db", "snr_db", "mse_db_observation"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-8, err_msg=k)
    np.testing.assert_allclose(tr["ssim"], jr["ssim"], rtol=1e-3)
    assert tr["salsa_iters"] == jr["salsa_iters"]
    assert tr["salsa_op_counts"] == jr["salsa_op_counts"] == {
        "A": 2 * tsol.n_iters, "AT": tsol.n_iters}
    np.testing.assert_allclose(tsol.x, np.asarray(jsol.x), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(tsol.objective, jsol.objective, rtol=1e-8)
    assert tr["mse_db"] < tr["mse_db_observation"]


def test_run_demo_rejects_an_unknown_solver():
    with pytest.raises(ValueError):
        t_cli.run_demo(tcfg.gaussian_preset(), synthetic_wheel(16), device="cpu",
                       solver="admm")
