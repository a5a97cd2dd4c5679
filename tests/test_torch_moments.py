"""Port vs JAX package: the Welford posterior moments of the SAPG estimator
(track_posterior_moments).

* the port fed the JAX draws gives the JAX `posterior_mean` and
  `posterior_var` (rtol 1e-10, float64), for one and two chains;
* they equal the brute-force mean and variance (ddof 1) over the
  post-burn-in samples of the same run, as tests/test_sapg.py checks for
  JAX, on every step route (the update reads the step's new sample after
  the kernel): the default, kernel B, C (in-kernel noise), D (dense DFT),
  and the blocked kernel's G and I forms, each forced on CPU tensors so
  the wrappers run their plain versions.
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
from semiblind_tv_tpu_torch.sapg.estimator import run_sapg
from tests.test_torch_sapg import jax_chain_draws, jax_problem_arrays, replay

SIZE = 32
MOMENTS_RTOL = 1e-10


def _moments(cfg, samples=24, warmup=4, burn_in=10, **sapg):
    return dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=samples, warmup=warmup, burn_in=burn_in,
        track_posterior_moments=True, **sapg))


@pytest.mark.parametrize("n_chains,fix_w", [(1, True), (2, False)])
def test_moments_match_jax(n_chains, fix_w):
    kw = dict(fix_w1=fix_w, fix_w2=fix_w)
    jc = _moments(jcfg.gaussian_preset(**kw))
    tc = _moments(tcfg.gaussian_preset(**kw))
    x = synthetic_wheel(SIZE)
    jp = j_build_problem(x, jc, jax.random.key(9), dtype=jnp.float64)
    jr = j_run_sapg(jp, jax.random.key(10), n_chains=n_chains)
    tp = problem_from_arrays(tc, jax_problem_arrays(jp), device="cpu", dtype=torch.float64)
    n_steps = (jc.sapg.warmup - 1) + (jc.sapg.samples - 1)
    draws = jax_chain_draws(jax.random.key(10), n_chains, x.shape, n_steps)
    tr = run_sapg(tp, n_chains=n_chains, noise=replay(draws))
    assert tr.posterior_mean.shape == (n_chains, SIZE, SIZE)
    np.testing.assert_allclose(tr.posterior_mean, jr.posterior_mean, rtol=MOMENTS_RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(tr.posterior_var, jr.posterior_var, rtol=MOMENTS_RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(tr.X_last, np.asarray(jr.X_last), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("route,sapg", [
    (None, {}),
    ("B", {}),
    ("B", dict(in_kernel_rng=True)),                     # kernel C
    ("B", dict(fft_mode="dft", fuse_dft=True)),          # kernel D
    ("G", {}),
    ("I", {}),
    ("I", dict(in_kernel_rng=True)),                     # I's seeds form
], ids=["default", "B", "C", "D", "G", "I", "I-seeds"])
def test_moments_equal_brute_force_on_every_route(route, sapg):
    cfg = _moments(tcfg.gaussian_preset(fix_w1=False, fix_w2=False), **sapg)
    problem = build_problem(synthetic_wheel(SIZE), cfg, torch.Generator().manual_seed(9),
                            dtype=torch.float64, device="cpu")
    burn_in = cfg.sapg.burn_in_resolved
    seen = []

    def record(seg_idx, carry):
        # one iteration a segment: the carry before ii = seg_idx + 2
        seen.append(carry[0].clone())
        return carry

    res = run_sapg(problem, torch.Generator().manual_seed(10), route=route, checkpoint_every=1,
                   fault_hook=record)
    # X after iteration ii is the carry before ii + 1; the last one is X_last
    xs = np.stack([x.numpy() for x in seen[burn_in:]] + [res.X_last])
    assert len(xs) == cfg.sapg.samples - burn_in
    np.testing.assert_allclose(res.posterior_mean, xs.mean(0), rtol=MOMENTS_RTOL, atol=1e-10)
    np.testing.assert_allclose(res.posterior_var, xs.var(0, ddof=1), rtol=1e-8, atol=1e-10)
    assert np.all(res.posterior_var >= 0)


def test_no_moments_without_the_option():
    cfg = tcfg.gaussian_preset()
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, samples=8, warmup=2))
    problem = build_problem(synthetic_wheel(16), cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    res = run_sapg(problem, torch.Generator().manual_seed(1))
    assert res.posterior_mean is None and res.posterior_var is None


def test_moments_with_one_post_burn_in_sample_have_zero_variance():
    """count = 1: the mean is that sample, M2 is 0 and var = M2 / max(0, 1)."""
    cfg = _moments(tcfg.gaussian_preset(), samples=6, warmup=2, burn_in=5)
    problem = build_problem(synthetic_wheel(16), cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float64, device="cpu")
    res = run_sapg(problem, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(res.posterior_mean, res.X_last)
    np.testing.assert_array_equal(res.posterior_var, 0.0)
