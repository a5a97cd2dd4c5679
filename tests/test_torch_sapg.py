"""Port vs JAX package: the SAPG estimator.

* one step of the port against the spatial-domain numpy oracle
  (oracles.np_sapg_gaussian_step), as tests/test_sapg.py does for JAX;
* 30-step trajectories (after a short warm-up) against JAX `run_sapg` for
  the Gaussian (w free), Laplace, Moffat and isotropic Gaussian families
  (the last runs kernel B's route with positivity off, σ² pinned and θ in
  log scale together): the JAX Problem goes
  into the port through `problem_from_arrays`, and the port's noise source
  replays the JAX draws, regenerated exactly as `estimator.chain_noise`
  makes them.

float64 throughout; trajectories agree to 1e-8 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.runtime import build_problem as j_build_problem
from semiblind_tv_tpu.runtime import config as jcfg
from semiblind_tv_tpu.sapg import run_sapg as j_run_sapg
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime.problem import build_problem, problem_from_arrays
from semiblind_tv_tpu_torch.sapg.estimator import (
    SAPGDivergenceError,
    make_sapg_step,
    run_sapg,
    run_segmented_scan,
)
from tests import oracles

SIZE = 32
RTOL = 1e-8


def _short(cfg, samples=30, warmup=5):
    return dataclasses.replace(
        cfg, sapg=dataclasses.replace(cfg.sapg, samples=samples, warmup=warmup,
                                      burn_in=(samples * 80) // 100)
    )


def jax_chain_draws(key, n_chains, shape, n_steps):
    """The JAX estimator's per-chain noise, step by step (chain_noise)."""
    keys = jax.random.split(key, n_chains)
    out = []
    for _ in range(n_steps):
        ks = jax.vmap(jax.random.split)(keys)
        keys, subs = ks[:, 0], ks[:, 1]
        out.append(np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float64))(subs)))
    return out


def replay(draws):
    it = iter(draws)
    return lambda shape: torch.tensor(next(it))


def jax_problem_arrays(p):
    names = ("x_true", "y", "yhat", "H_true", "kernel_true", "sigma_true", "sigma2_init",
             "ev_max", "Lf", "lambda_myula", "gamma")
    arrays = {n: np.asarray(getattr(p, n)) for n in names}
    arrays["sigma2_box"] = tuple(np.asarray(v) for v in p.sigma2_box)
    return arrays


def test_one_step_matches_spatial_oracle():
    cfg = tcfg.gaussian_preset(fix_w1=False, fix_w2=False)
    x = synthetic_wheel(SIZE)
    obs = np.random.default_rng(0).standard_normal(x.shape)
    problem = build_problem(x, cfg, dtype=torch.float64, device="cpu", noise=obs)
    step, aux = make_sapg_step(problem, n_chains=1)

    theta0, sigma0, params0 = aux["theta0"], problem.sigma2_init, dict(aux["params0"])
    X0 = problem.y[None]
    prox0 = aux["prox_b"](X0, aux["lam"] * theta0)[0]
    Z = np.random.default_rng(1).standard_normal(x.shape)
    carry0 = aux["main_carry"]((X0, torch.fft.rfft2(X0), prox0), aux["consts"])
    assert [float(v) for v in (carry0[3], carry0[4], *carry0[5].values())] == [
        float(v) for v in (theta0, sigma0, *params0.values())]
    (X1, _, prox1, theta1, sigma1, params1), trace = step(carry0, 2, torch.from_numpy(Z)[None])

    boxes = dict(theta=cfg.theta.box, w1=(0.1, 1.0), w2=(0.1, 1.0),
                 sigma=tuple(float(v) for v in problem.sigma2_box))
    oX1, oprox1, otheta1, ow1, ow2, osigma1, stats = oracles.np_sapg_gaussian_step(
        problem.y.numpy(), prox0[0].numpy(), Z, problem.y.numpy(),
        float(theta0), float(params0["w1"]), float(params0["w2"]), float(sigma0),
        cfg.psf_size, cfg.phi, float(problem.gamma), float(problem.lambda_myula),
        1.0, cfg.sapg.d_exp, 2,
        cfg.theta.step_scale, 10.0, 10.0, cfg.sigma_step_scale,
        boxes, dict(w1=False, w2=False, sigma=False),
        dict(w1=0.4, w2=0.3), float(problem.sigma2_init),
    )
    np.testing.assert_allclose(X1[0].numpy(), oX1, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(prox1[0].numpy(), oprox1, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(float(theta1), otheta1, rtol=1e-8)
    np.testing.assert_allclose(float(params1["w1"]), ow1, rtol=1e-8)
    np.testing.assert_allclose(float(params1["w2"]), ow2, rtol=1e-8)
    np.testing.assert_allclose(float(sigma1), osigma1, rtol=1e-8)
    np.testing.assert_allclose(float(trace["G_t"]), stats["G_t"], rtol=1e-8)
    np.testing.assert_allclose(float(trace["G_w1"]), stats["G_w1"], rtol=1e-6)
    np.testing.assert_allclose(float(trace["G_s"]), stats["G_s"], rtol=1e-6)
    np.testing.assert_allclose(float(trace["logPi"]), stats["logPi"], rtol=1e-8)


@pytest.mark.parametrize("family,n_chains,fused", [
    ("gaussian", 1, None),
    ("gaussian", 2, False),   # the unfused route: MYULA step, prox, TV apart
    ("laplace", 1, None),
    ("moffat", 2, None),
    ("isotropic_gaussian", 1, None),
])
def test_trajectory_matches_jax(family, n_chains, fused):
    kw = dict(fix_w1=False, fix_w2=False) if family == "gaussian" else {}
    jc = _short(jcfg.preset(family, **kw))
    tc = _short(tcfg.preset(family, **kw))
    tc = dataclasses.replace(tc, sapg=dataclasses.replace(tc.sapg, use_fused_step=fused))
    x = synthetic_wheel(SIZE)
    jp = j_build_problem(x, jc, jax.random.key(1), dtype=jnp.float64)
    jr = j_run_sapg(jp, jax.random.key(2), n_chains=n_chains)

    tp = problem_from_arrays(tc, jax_problem_arrays(jp), device="cpu", dtype=torch.float64)
    n_steps = (jc.sapg.warmup - 1) + (jc.sapg.samples - 1)
    draws = jax_chain_draws(jax.random.key(2), n_chains, x.shape, n_steps)
    tr = run_sapg(tp, n_chains=n_chains, noise=replay(draws))

    np.testing.assert_allclose(tr.thetas, jr.thetas, rtol=RTOL)
    np.testing.assert_allclose(tr.sigma2s, jr.sigma2s, rtol=RTOL)
    for n in jr.psf_param_traces:
        np.testing.assert_allclose(tr.psf_param_traces[n], jr.psf_param_traces[n], rtol=RTOL)
        np.testing.assert_allclose(tr.grad_psf[n], jr.grad_psf[n], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tr.mean_psf[n], jr.mean_psf[n], rtol=RTOL)
    np.testing.assert_allclose(tr.logPiTrace, jr.logPiTrace, rtol=RTOL)
    np.testing.assert_allclose(tr.logPiTrace_warmup, jr.logPiTrace_warmup, rtol=RTOL)
    np.testing.assert_allclose(tr.gX, jr.gX, rtol=RTOL)
    np.testing.assert_allclose(tr.grad_theta, jr.grad_theta, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tr.mean_thetas, jr.mean_thetas, rtol=RTOL)
    np.testing.assert_allclose(tr.tol_thetas, jr.tol_thetas, rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(tr.err_psf, jr.err_psf, rtol=1e-7, atol=1e-14)
    np.testing.assert_allclose(tr.X_last, np.asarray(jr.X_last), rtol=RTOL, atol=1e-8)
    np.testing.assert_allclose(tr.theta_EB, jr.theta_EB, rtol=RTOL)
    np.testing.assert_allclose(tr.sigma2_EB, jr.sigma2_EB, rtol=RTOL)
    assert tr.X_last.shape == (n_chains, SIZE, SIZE)


def test_fixed_psf_params_stay_true_and_otf_is_hoisted():
    cfg = _short(tcfg.gaussian_preset(), samples=12, warmup=3)
    x = synthetic_wheel(SIZE)
    gen = torch.Generator().manual_seed(4)
    problem = build_problem(x, cfg, gen, dtype=torch.float64, device="cpu")
    res = run_sapg(problem, gen)
    np.testing.assert_allclose(res.psf_param_traces["w1"][1:], 0.4)
    np.testing.assert_allclose(res.psf_param_traces["w2"][1:], 0.3)
    np.testing.assert_array_equal(res.grad_psf["w1"], 0.0)
    assert len(res.logPiTrace_warmup) == cfg.sapg.warmup
    assert res.thetas.shape == (cfg.sapg.samples,)
    assert np.all(res.X_last >= 0)


@pytest.mark.parametrize("option", [
    "sigma_log_scale", "psf_log_scale", "theta_log_scale", "track_posterior_moments",
    "in_kernel_rng", "fuse_dft", "fuse_irdft",
])
def test_unported_options_raise(option):
    """Every option that once raised as not ported runs now: the log-scale
    options, the in-kernel-noise and DFT-kernel options and the posterior
    moments (tests/test_torch_large_path.py, tests/test_torch_dft.py and
    tests/test_torch_moments.py hold them against the JAX package)."""
    cfg = _short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False), samples=6, warmup=2)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **{option: True}))
    problem = build_problem(synthetic_wheel(16), cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    res = run_sapg(problem, torch.Generator().manual_seed(1))
    assert np.all(np.isfinite(res.thetas)) and np.all(np.isfinite(res.sigma2s))
    assert (res.posterior_mean is not None) == (option == "track_posterior_moments")


def test_mesh_argument_runs():
    """run_sapg(mesh=) on a 1x1 mesh (a one-process gloo world, torn down
    after) runs the sharded path: the single-device trajectory
    (tests/test_torch_parallel.py holds the larger worlds)."""
    import torch.distributed as dist

    from semiblind_tv_tpu_torch.parallel.mesh import make_mesh

    cfg = _short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False), samples=8, warmup=3)
    problem = build_problem(synthetic_wheel(16), cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float64, device="cpu")
    try:
        mesh = make_mesh(1, 1, device_type="cpu")
        got = run_sapg(problem, torch.Generator().manual_seed(1), n_chains=2, mesh=mesh)
    finally:
        dist.destroy_process_group()
    ref = run_sapg(problem, torch.Generator().manual_seed(1), n_chains=2)
    np.testing.assert_array_equal(got.thetas, ref.thetas)
    np.testing.assert_array_equal(got.X_last, ref.X_last)


def test_nan_guard_raises_on_non_finite_traces():
    def scan_seg(carry, iis):
        n = len(list(iis))
        return carry, {"theta": np.full(n, np.nan), "logPi": np.zeros(n)}

    with pytest.raises(SAPGDivergenceError):
        run_segmented_scan(scan_seg, None, 5)
    carry, segs = run_segmented_scan(scan_seg, "c", 5, nan_guard=False)
    assert carry == "c" and len(segs) == 1 and len(segs[0]["theta"]) == 4


def test_standalone_myula_sampler_matches_jax():
    """samplers.myula_sampler (SALSA/myula.m) fed the JAX draws: the last
    sample and the chain mean agree with JAX `myula_sampler` to 1e-8."""
    from semiblind_tv_tpu.samplers import myula_sampler as j_myula_sampler
    from semiblind_tv_tpu_torch.samplers import myula_sampler

    jc = jcfg.gaussian_preset()
    x = synthetic_wheel(SIZE)
    jp = j_build_problem(x, jc, jax.random.key(4), dtype=jnp.float64)
    H = jp.H_true

    def j_grad(v):
        return jp.blur.irfft(np.conj(H) * (H * jnp.fft.rfft2(v) - jnp.asarray(jp.yhat))) \
            / jp.sigma2_init

    n_steps = 12
    jx, jmean = j_myula_sampler(j_grad, jp.y, jax.random.key(5), n_steps=n_steps,
                                gamma=jp.gamma, lam=jp.lambda_myula, theta=0.01)
    keys = jax.random.split(jax.random.key(5), n_steps)
    draws = [np.array(jax.random.normal(k, x.shape, jnp.float64)) for k in keys]

    tp = problem_from_arrays(tcfg.gaussian_preset(), jax_problem_arrays(jp), device="cpu",
                             dtype=torch.float64)
    tH = tp.H_true

    def t_grad(v):
        return tp.blur.irfft(torch.conj(tH) * (tH * torch.fft.rfft2(v) - tp.yhat)) \
            / tp.sigma2_init

    it = iter(draws)
    tx, tmean = myula_sampler(t_grad, tp.y, None, n_steps, tp.gamma, tp.lambda_myula, 0.01,
                              noise=lambda shape: torch.from_numpy(next(it)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=1e-8)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=RTOL, atol=1e-8)
    # the default source: normals from the generator, positive samples
    gx, gmean = myula_sampler(t_grad, tp.y, torch.Generator().manual_seed(0), 5, tp.gamma,
                              tp.lambda_myula, 0.01)
    assert torch.all(gx >= 0) and torch.isfinite(gmean).all()
