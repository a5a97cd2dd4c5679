"""The port's large-image path around the blocked kernels, on the CPU.

* One SAPG step with each log-scale option (sigma_log_scale, psf_log_scale,
  theta_log_scale) against the JAX package's make_general_sapg_step, with
  the JAX draws injected, at 32², float64, within 1e-10 relative.
* The route functions: kernel B / A1 / A2 up to 512², the blocked kernels
  above (the counterparts of G/F up to 1024² pixels and I/H beyond), the
  plain versions on the CPU; nothing is launched to decide.
* Every forced route runs on a CPU tensor through the same plain versions,
  so the estimator's and SALSA's kernel branches (σ² folded into the
  blocked fused step for I) are held equal to the plain path.
* `run_demo` with --sigma-log-scale at 32² against the JAX `run_demo` with
  the same draws, and the CLI's new flags.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.cli.run_demo import run_demo as j_run_demo
from semiblind_tv_tpu.runtime import build_problem as j_build_problem
from semiblind_tv_tpu.runtime import config as jcfg
from semiblind_tv_tpu.sapg.estimator import make_sapg_step as j_make_sapg_step
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.cli import run_demo as t_cli
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime.problem import build_problem, problem_from_arrays
from semiblind_tv_tpu_torch.sapg.estimator import (
    make_sapg_step,
    resolve_prox_route,
    resolve_step_route,
    run_sapg,
)
from semiblind_tv_tpu_torch.solvers.salsa import resolve_salsa_prox_mode, salsa_tv
from tests.test_torch_sapg import jax_chain_draws, jax_problem_arrays, replay

SIZE = 32
RTOL = 1e-10


def _with(cfg, **sapg):
    return dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg))


@pytest.mark.parametrize("option", ["sigma_log_scale", "psf_log_scale", "theta_log_scale"])
def test_log_scale_step_matches_jax(option):
    jc = _with(jcfg.gaussian_preset(fix_w1=False, fix_w2=False), **{option: True})
    tc = _with(tcfg.gaussian_preset(fix_w1=False, fix_w2=False), **{option: True})
    x = synthetic_wheel(SIZE)
    jp = j_build_problem(x, jc, jax.random.key(1), dtype=jnp.float64)
    tp = problem_from_arrays(tc, jax_problem_arrays(jp), device="cpu", dtype=torch.float64)

    jstep, jaux = j_make_sapg_step(jp, n_chains=1)
    theta0 = jnp.float64(jc.theta.init)
    params0 = {k: jnp.float64(v) for k, v in jc.init_psf_params().items()}
    X0 = jp.y[None]
    jprox0, _ = jaux["prox_b"](X0, jaux["lam"] * theta0)
    key = jax.random.key(3)
    jcarry = (X0, jnp.fft.rfft2(X0), jprox0, jax.random.split(key, 1), theta0,
              jp.sigma2_init, params0, {})
    tstep, taux = make_sapg_step(tp, n_chains=1)
    T0 = tp.y[None]
    tcarry = taux["main_carry"](
        (T0, torch.fft.rfft2(T0), taux["prox_b"](T0, taux["lam"] * taux["theta0"])[0]),
        taux["consts"])
    draws = jax_chain_draws(key, 1, x.shape, 3)
    for ii, Z in zip((2, 3, 4), draws):
        jcarry, jtr = jstep(jcarry, jnp.float64(ii))
        tcarry, ttr = tstep(tcarry, ii, torch.tensor(Z))
        for name in ("theta", "sigma2", "w1", "w2", "logPi", "G_t", "G_s", "G_w1"):
            np.testing.assert_allclose(float(ttr[name]), float(jtr[name]), rtol=RTOL,
                                       err_msg=f"{name} at ii={ii}")
        np.testing.assert_allclose(tcarry[0].numpy(), np.asarray(jcarry[0]), rtol=RTOL,
                                   atol=1e-10)
        np.testing.assert_allclose(tcarry[2].numpy(), np.asarray(jcarry[2]), rtol=RTOL,
                                   atol=1e-10)


def test_theta_log_scale_eb_is_the_geometric_mean():
    tc = dataclasses.replace(
        tcfg.gaussian_preset(), sapg=dataclasses.replace(
            tcfg.gaussian_preset().sapg, samples=20, warmup=4, burn_in=12,
            theta_log_scale=True, positivity=False))
    x = synthetic_wheel(SIZE)
    gen = torch.Generator().manual_seed(2)
    res = run_sapg(build_problem(x, tc, gen, dtype=torch.float64, device="cpu"), gen)
    window = res.thetas[tc.sapg.burn_in - 1:]
    np.testing.assert_allclose(res.theta_EB, np.exp(np.mean(np.log(window))), rtol=1e-12)
    lo, hi = tc.theta.box
    assert np.all((res.thetas >= lo) & (res.thetas <= hi))


@pytest.mark.parametrize("shape,step,prox,salsa", [
    ((512, 512), "B", "A2", "A1"),
    ((480, 352), "B", "A2", "A1"),
    ((513, 512), "G", "F", "F"),
    ((1024, 1024), "G", "F", "F"),
    ((1000, 1048), "G", "F", "F"),
    ((2048, 2048), "I", "H", "H"),
    ((1000, 1528), "I", "H", "H"),
])
def test_routes_by_size_on_a_cuda_device(shape, step, prox, salsa):
    cuda = torch.device("cuda")   # a device object only: nothing is allocated
    assert resolve_step_route(shape, cuda) == step
    assert resolve_prox_route(shape, cuda) == prox
    assert resolve_salsa_prox_mode(shape, cuda) == salsa
    for dev in ("cpu", torch.device("cpu")):
        assert resolve_step_route(shape, dev) == "plain"
        assert resolve_prox_route(shape, dev) == "plain"
        assert resolve_salsa_prox_mode(shape, dev) == "plain"


def _small_problem(family="gaussian"):
    kw = dict(fix_w1=False, fix_w2=False) if family == "gaussian" else {}
    tc = _with(tcfg.preset(family, **kw), samples=8, warmup=3, burn_in=6)
    x = synthetic_wheel(SIZE)
    return build_problem(x, tc, torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu",
                         noise=np.random.default_rng(0).standard_normal(x.shape))


@pytest.mark.parametrize("route", ["B", "G", "I"])
def test_forced_step_routes_on_cpu_equal_the_plain_path(route):
    problem = _small_problem()
    draws = [np.random.default_rng(k).standard_normal((2, SIZE, SIZE)) for k in range(9)]
    ref = run_sapg(problem, n_chains=2, noise=replay(draws), route="plain")
    res = run_sapg(problem, n_chains=2, noise=replay(draws), route=route)
    np.testing.assert_array_equal(res.thetas, ref.thetas)
    np.testing.assert_array_equal(res.sigma2s, ref.sigma2s)
    np.testing.assert_array_equal(res.X_last, ref.X_last)


def test_unknown_step_route_raises():
    with pytest.raises(ValueError):
        make_sapg_step(_small_problem(), 1, route="tiled")


@pytest.mark.parametrize("prox_route", ["A1", "F", "H"])
def test_forced_salsa_routes_on_cpu_equal_the_plain_path(prox_route):
    p = _small_problem("laplace")
    kw = dict(tau=0.05 * float(p.sigma_true) ** 2, mu=0.005, blur=p.blur, max_iter=40,
              x_true=p.x_true)
    ref = salsa_tv(p.y, p.H_true, prox_route="plain", **kw)
    res = salsa_tv(p.y, p.H_true, prox_route=prox_route, **kw)
    np.testing.assert_array_equal(res.x, ref.x)
    np.testing.assert_array_equal(res.objective, ref.objective)
    assert res.n_iters == ref.n_iters


def test_run_demo_sigma_log_scale_matches_jax_run_demo():
    def short(cfg):
        return dataclasses.replace(
            cfg, sapg=dataclasses.replace(cfg.sapg, samples=40, warmup=20, burn_in=32,
                                          sigma_log_scale=True),
            salsa=dataclasses.replace(cfg.salsa, outer_iters=50))

    jc = short(jcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    tc = short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    img = synthetic_wheel(SIZE)
    jr, js, jsal, _ = j_run_demo(jc, img, dtype=jnp.float64)
    k_prob, k_sapg = jax.random.split(jax.random.key(jc.seed))
    obs = np.asarray(jax.random.normal(k_prob, img.shape, jnp.float64))
    draws = jax_chain_draws(k_sapg, 1, img.shape, (20 - 1) + (40 - 1))
    tr, ts, tsal, _ = t_cli.run_demo(tc, img, dtype=torch.float64, device="cpu",
                                     obs_noise=obs, noise=replay(draws))
    for k in ("theta_EB", "sigma2_EB", "mse_db", "psnr_db", "snr_db"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-8, err_msg=k)
    np.testing.assert_allclose(ts.sigma2s, js.sigma2s, rtol=1e-8)
    np.testing.assert_allclose(tsal.x, np.asarray(jsal.x), rtol=1e-8, atol=1e-8)


def test_cli_log_scale_flags(tmp_path):
    out = tmp_path / "demo"
    res = t_cli.main(["--device", "cpu", "--image", "synthetic", "--size", "32",
                      "--samples", "10", "--warmup", "4", "--no-fix-w",
                      "--sigma-log-scale", "--psf-log-scale", "--out", str(out)])
    assert np.isfinite(res["sigma2_EB"]) and np.isfinite(res["psf_params_EB"]["w1"])
    assert (out / "results.json").exists()
