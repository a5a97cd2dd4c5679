"""The in-kernel noise of the port: ops/rng.py::philox_normals (the plain
version of csrc/rng.cuh) and the steps that draw from it, kernel C
(ops/fused_step_cuda.myula_prox_tv_rng) and kernel I's seeds form
(myula_prox_tv_blocked(z=None, seeds=...)), on the CPU.

* Philox4x32-10 reproduces Random123's known-answer vectors.
* The normals pass the moment bands of tests/test_tpu_only.py's in-kernel
  RNG test at 256²; the same seeds give the same field, other seeds
  another; a batched draw equals the single-chain draws row by row.
* The steps with seeds equal, exactly, the same plain versions fed the
  field philox_normals(seeds), and the JAX kernels (myula_prox_tv,
  myula_prox_tv_streamed in interpret mode) fed that field, to 1e-10 and
  1e-12 relative in float64.  The JAX in-kernel RNG itself
  (pltpu.prng_seed) has no CPU lowering, so the JAX side is fed the field.
* Through the estimator: in_kernel_rng on the CPU ('plain' route) leaves
  the default trajectory, and JAX's, unchanged; with route 'B' or 'I'
  forced on CPU tensors and injected seeds, the step equals the default
  path fed philox_normals of those seeds.
"""
import jax
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops.fused_step_pallas import myula_prox_tv as j_myula_prox_tv
from semiblind_tv_tpu.ops.fused_step_pallas import myula_prox_tv_streamed
from semiblind_tv_tpu.sapg import run_sapg as j_run_sapg
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.ops import fused_step_cuda as fs
from semiblind_tv_tpu_torch.ops.rng import philox4x32_10, philox_normals
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime.problem import build_problem, problem_from_arrays
from semiblind_tv_tpu_torch.sapg import estimator as est
from tests.test_torch_blocked import _j, _rel, _step_inputs, _t
from tests.test_torch_dft import SIZE, _jax_and_port_problems, _port_run, _short, _with
from tests.test_torch_sapg import jax_chain_draws, jax_problem_arrays, replay


def _seeds(*pairs):
    return torch.tensor(pairs, dtype=torch.int32)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    as_t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    got = philox4x32_10(tuple(map(as_t, counter)), tuple(map(as_t, key)))
    assert tuple(int(w) for w in got) == want


def test_normals_moments_and_determinism():
    """The bands of tests/test_tpu_only.py::test_in_kernel_rng_statistics_and_determinism."""
    seeds = _seeds((123, 456))[0]
    z = philox_normals(seeds, (256, 256)).double()
    n = z.numel()
    assert abs(float(z.mean())) < 5.0 / np.sqrt(n)
    assert abs(float(z.var()) - 1.0) < 0.05
    assert abs(float((z ** 3).mean())) < 0.1
    assert abs(float((z ** 4).mean()) - 3.0) < 0.3
    assert torch.equal(philox_normals(seeds, (256, 256)), z.float())
    assert float((philox_normals(seeds + 1, (256, 256)) - z).abs().max()) > 0.1


@pytest.mark.parametrize("shape", [(64, 64), (17, 33), (5, 7)])
def test_batched_draw_equals_single_draws(shape):
    sb = _seeds((11, 22), (123, 456), (-5, 2 ** 31 - 1))
    zb = philox_normals(sb, shape)
    assert zb.shape == (3,) + shape and zb.is_contiguous()
    for i in range(3):
        assert torch.equal(zb[i], philox_normals(sb[i], shape))
    assert float((zb[0] - zb[1]).abs().max()) > 0.1
    assert torch.isfinite(zb).all()


def test_kernel_c_noise_field_is_philox():
    """x = prox = grad = 0, γ = 0.5, positivity off: the step's xn is the raw
    noise field (the statistics test's set-up)."""
    seeds = _seeds((7, 8), (9, 10))
    zero = torch.zeros((2, 64, 48))
    xn, _, _ = fs.myula_prox_tv_rng(zero, zero, zero, seeds, 0.5, 1.0, 0.02, n_sweeps=1,
                                    positivity=False)
    assert torch.equal(xn, philox_normals(seeds, (64, 48)))


@pytest.mark.parametrize("shape,positivity", [((2, 32, 32), True), ((3, 24, 35), False)])
def test_kernel_c_plain_equals_field_fed_step_and_jax(shape, positivity):
    x, prox, grad, _ = _step_inputs(shape, seed=8)
    seeds = _seeds(*[(17 * b + 1, -3 * b) for b in range(shape[0])])
    sc = (0.03, 0.9, 0.04)
    z = philox_normals(seeds, shape[1:], torch.float64)
    for tol in (0.0, 1e-3):
        kw = dict(n_sweeps=25, tol=tol, positivity=positivity)
        c = fs.myula_prox_tv_rng(*_t(x, prox, grad), seeds, *sc, **kw)
        b = fs.myula_prox_tv_plain(*_t(x, prox, grad), z, *sc, **kw)
        for u, v in zip(c, b):
            assert torch.equal(u, v)
        j = j_myula_prox_tv(*_j(x, prox, grad, z.numpy()), *sc, interpret=True, **kw)
        for u, v in zip(c, j):
            assert _rel(u.numpy(), v) <= 1e-10


@pytest.mark.parametrize("tile_rows,positivity", [(16, False), (32, True)])
def test_blocked_seeds_form_equals_field_fed_and_jax_streamed(tile_rows, positivity):
    """Kernel I's seeds form: the blocked step with
    seeds equals the same step fed philox_normals(seeds), and the JAX
    streamed kernel fed that field, at the inputs and bound of
    tests/test_torch_blocked.py::test_fused_matches_jax_streamed."""
    x, prox, grad, _ = _step_inputs(seed=6)
    seeds = _seeds((3, 4), (5, -6))
    z = philox_normals(seeds, x.shape[1:], torch.float64)
    sc = (0.03, 0.9, 0.04, 2.5)
    for tol in (0.0, 1e-3):
        kw = dict(n_sweeps=25, tol=tol, positivity=positivity)
        t = fs.myula_prox_tv_blocked(*_t(x, prox, grad), None, *sc, seeds=seeds, **kw)
        f = fs.myula_prox_tv_blocked(*_t(x, prox, grad), z, *sc, **kw)
        for u, v in zip(t, f):
            assert torch.equal(u, v)
        j = myula_prox_tv_streamed(*_j(x, prox, grad, z.numpy()), *sc, tile_rows=tile_rows,
                                   interpret=True, **kw)
        for u, v in zip(t, j):
            assert _rel(u.numpy(), v) <= 1e-12


def test_blocked_step_takes_exactly_one_noise_source():
    f = torch.zeros((1, 16, 16))
    with pytest.raises(ValueError):
        fs.myula_prox_tv_blocked(f, f, f, f, 1.0, 1.0, 0.1, seeds=_seeds((1, 2)))
    with pytest.raises(ValueError):
        fs.myula_prox_tv_blocked(f, f, f, None, 1.0, 1.0, 0.1)


def test_in_kernel_rng_on_cpu_is_the_default_trajectory_and_jax():
    """JAX auto-gates the option off on the CPU; the port's 'plain' route
    does the same, so both trajectories equal the default's."""
    kw = dict(fix_w1=False, fix_w2=False)
    jc, jp, tp, x = _jax_and_port_problems("gaussian", kw, in_kernel_rng=True)
    jr = j_run_sapg(jp, jax.random.key(2))
    draws = jax_chain_draws(jax.random.key(2), 1, x.shape, (5 - 1) + (30 - 1))
    tr = est.run_sapg(tp, noise=replay(draws))
    tr0 = est.run_sapg(problem_from_arrays(_with(tp.cfg, in_kernel_rng=False),
                                           jax_problem_arrays(jp), device="cpu",
                                           dtype=torch.float64),
                       noise=replay(draws))
    np.testing.assert_array_equal(tr.thetas, tr0.thetas)
    np.testing.assert_array_equal(tr.X_last, tr0.X_last)
    np.testing.assert_allclose(tr.thetas, jr.thetas, rtol=1e-8)
    np.testing.assert_allclose(tr.sigma2s, jr.sigma2s, rtol=1e-8)


@pytest.mark.parametrize("route", ["B", "I"])
def test_forced_in_kernel_rng_equals_the_philox_fed_default(route):
    """Kernel C (route B) and I's seeds form (route I) through the
    estimator, with injected seeds, against the default path fed
    philox_normals of the same seeds."""
    base = _short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    rng = np.random.default_rng(9)
    seeds = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (2, 2)).astype(np.int32))
             for _ in range(33)]
    it = iter(seeds)
    res = _port_run(_with(base, in_kernel_rng=True), route=route, n_chains=2,
                    seeds=lambda B: next(it))
    it = iter(seeds)
    x = synthetic_wheel(SIZE)
    problem = build_problem(x, base, dtype=torch.float64, device="cpu",
                            noise=np.random.default_rng(0).standard_normal(x.shape))
    ref = est.run_sapg(problem, n_chains=2, route=route,
                       noise=lambda shape: philox_normals(next(it), shape[1:], torch.float64))
    np.testing.assert_array_equal(res.thetas, ref.thetas)
    np.testing.assert_array_equal(res.sigma2s, ref.sigma2s)
    np.testing.assert_array_equal(res.X_last, ref.X_last)
