"""Port vs JAX package: the wavelet path — `ops/wavelet.py` (daubcqf, the TI
frames, the uniform blur), `sapg/wavelet_l1.py` and `cli/run_wavelet_l1`,
float64 on the CPU.

* 1e-12 relative: `daubcqf` at every phase ('min', 'mid', 'max') for
  N = 2 … 12; `ti_analysis`/`ti_synthesis` at orders 2, 4, 8 and levels 1,
  3 on (M, N) and batched fields; the tight frame W(WT x) = x and the
  adjoint pair ⟨WT x, z⟩ = ⟨x, W z⟩; `uniform_blur_kernel`.
* `run_sapg_wavelet_l1` at 32², L = 2, 50 samples, fed the JAX draws (the
  key schedule of wavelet_l1.py replayed: the split at :103, the
  observation noise at :127, then one split and one normal a step at
  :150-151): the θ trace, logπ, the last sample, θ_EB and x_map within
  1e-9, the same SALSA iteration count.
* The CLI at 32² on the CPU (`--device cpu`), against the JAX CLI.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.cli import run_wavelet_l1 as j_cli
from semiblind_tv_tpu.ops import wavelet as jw
from semiblind_tv_tpu.sapg import wavelet_l1 as jwl
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.cli import run_wavelet_l1 as t_cli
from semiblind_tv_tpu_torch.ops import wavelet as tw
from semiblind_tv_tpu_torch.sapg import wavelet_l1 as twl


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU FFT of a 32² field takes ~20× longer on eight threads
    than on one (and far longer when the test workers share the cores):
    the module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("phase", ["min", "mid", "max"])
def test_daubcqf_matches_jax(phase):
    for N in range(2, 13, 2):
        for a, b in zip(tw.daubcqf(N, phase), jw.daubcqf(N, phase)):
            assert _rel(a, b) <= 1e-12, (N, phase)
    np.testing.assert_allclose(tw.daubcqf(4)[0], [0.48296291, 0.83651630, 0.22414387,
                                                  -0.12940952], atol=1e-8)


def test_daubcqf_rejects_bad_arguments():
    for args in ((5,), (0,), (4, "linear")):
        with pytest.raises(ValueError):
            tw.daubcqf(*args)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("levels", [1, 3])
def test_ti_transforms_match_jax(order, levels):
    rng = np.random.default_rng(order * 10 + levels)
    x = rng.standard_normal((32, 40))
    z = rng.standard_normal((32, 40 * (3 * levels + 1)))
    a = tw.ti_analysis(torch.from_numpy(x), levels, order)
    s = tw.ti_synthesis(torch.from_numpy(z), levels, order)
    assert a.shape == (32, 40 * (3 * levels + 1)) and s.shape == (32, 40)
    assert _rel(a, jw.ti_analysis(jnp.asarray(x), levels, order)) <= 1e-12
    assert _rel(s, jw.ti_synthesis(jnp.asarray(z), levels, order)) <= 1e-12
    # tight frame and adjoint pair
    assert _rel(tw.ti_synthesis(a, levels, order), x) <= 1e-12
    lhs = float(torch.sum(a * torch.from_numpy(z)))
    assert lhs == pytest.approx(float(np.sum(x * s.numpy())), rel=1e-12)


def test_ti_transforms_on_batched_fields_and_haar():
    rng = np.random.default_rng(1)
    xb = torch.from_numpy(rng.standard_normal((3, 16, 24)))
    ab = tw.ti_analysis(xb, 2, 4)
    for i in range(3):
        np.testing.assert_array_equal(ab[i].numpy(), tw.ti_analysis(xb[i], 2, 4).numpy())
    np.testing.assert_array_equal(tw.ti_synthesis(ab, 2, 4)[1].numpy(),
                                  tw.ti_synthesis(ab[1], 2, 4).numpy())
    np.testing.assert_array_equal(tw.ti_haar_analysis(xb, 2).numpy(),
                                  tw.ti_analysis(xb, 2, 2).numpy())
    np.testing.assert_array_equal(tw.ti_haar_synthesis(ab, 2).numpy(),
                                  tw.ti_synthesis(ab, 2, 2).numpy())


def test_ti_transforms_in_float32_match_jax():
    x = np.random.default_rng(2).standard_normal((32, 32)).astype(np.float32)
    a = tw.ti_analysis(torch.from_numpy(x), 3, 4)
    assert a.dtype == torch.float32
    assert _rel(a, jw.ti_analysis(jnp.asarray(x), 3, 4)) <= 1e-6


def test_uniform_blur_kernel_matches_jax():
    for size, length in ((32, 9), (17, 4), (8, 1)):
        np.testing.assert_array_equal(tw.uniform_blur_kernel(size, length),
                                      jw.uniform_blur_kernel(size, length))


# ----------------------------- wavelet-L1 SAPG -----------------------------

CFG = dict(samples=50, burn_in=20, levels=2, blur_length=5, salsa_iters=120, salsa_tol=1e-6)


def _jax_draws(seed, cfg, shape):
    """The JAX run's observation noise and per-step normals, replayed from
    its key schedule (wavelet_l1.py:103, :127, :150-151)."""
    _, k_noise, k_chain = jax.random.split(jax.random.key(seed), 3)
    obs = np.asarray(jax.random.normal(k_noise, shape, jnp.float64))
    wshape = (shape[0], shape[1] * (3 * cfg.levels + 1))
    key, steps = k_chain, []
    for _ in range(cfg.samples - 1):
        key, sub = jax.random.split(key)
        steps.append(np.asarray(jax.random.normal(sub, wshape, jnp.float64)))
    return obs, np.stack(steps)


@pytest.fixture(scope="module")
def jax_run():
    x = synthetic_wheel(32)
    jres = jwl.run_sapg_wavelet_l1(x, jwl.WaveletL1Config(**CFG), jax.random.key(0),
                                   dtype=jnp.float64)
    return x, jres


def test_run_sapg_wavelet_l1_matches_jax_with_its_draws(jax_run):
    x, jres = jax_run
    cfg = twl.WaveletL1Config(**CFG)
    obs, steps = _jax_draws(0, cfg, x.shape)
    tres = twl.run_sapg_wavelet_l1(x, cfg, dtype=torch.float64, device="cpu", obs_noise=obs,
                                   noise=steps)
    assert _rel(tres.thetas, jres.thetas) <= 1e-9
    assert _rel(tres.logPiTrace, jres.logPiTrace) <= 1e-9
    assert _rel(tres.xw_last, jres.xw_last) <= 1e-9
    assert _rel(tres.x_map, jres.x_map) <= 1e-9
    assert tres.theta_EB == pytest.approx(jres.theta_EB, rel=1e-9)
    assert tres.mse_db == pytest.approx(jres.mse_db, rel=1e-9)
    assert tres.salsa_iters == jres.salsa_iters
    assert len(tres.thetas) == cfg.samples


def test_run_sapg_wavelet_l1_noise_callable_and_generator():
    """A callable noise source equals the same draws as a field; the
    default draws from the generator land θ_EB in its box."""
    x = synthetic_wheel(32)
    cfg = twl.WaveletL1Config(samples=12, burn_in=4, levels=2, blur_length=5, salsa_iters=20)
    rng = np.random.default_rng(3)
    obs = rng.standard_normal(x.shape)
    steps = rng.standard_normal((11, 32, 32 * 7))
    it = iter(steps)
    a = twl.run_sapg_wavelet_l1(x, cfg, dtype=torch.float64, device="cpu", obs_noise=obs,
                                noise=steps)
    b = twl.run_sapg_wavelet_l1(x, cfg, dtype=torch.float64, device="cpu", obs_noise=obs,
                                noise=lambda shape: torch.from_numpy(next(it)))
    np.testing.assert_array_equal(a.thetas, b.thetas)
    np.testing.assert_array_equal(a.x_map, b.x_map)
    gen = torch.Generator()
    gen.manual_seed(4)
    c = twl.run_sapg_wavelet_l1(x, cfg, gen, dtype=torch.float32, device="cpu")
    assert cfg.min_th <= c.theta_EB <= cfg.max_th
    assert np.all(np.isfinite(c.x_map)) and c.x_map.dtype == np.float32
    with pytest.raises(ValueError):
        twl.run_sapg_wavelet_l1(x, twl.WaveletL1Config(levels=0), gen, device="cpu")


def test_run_wavelet_l1_cli_matches_jax_keys(capsys):
    argv = ["--image", "synthetic", "--size", "32", "--samples", "30", "--levels", "2"]
    out = t_cli.main(argv + ["--device", "cpu", "--f64"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["theta_EB"] == out["theta_EB"]
    jout = j_cli.main(argv + ["--f64"])
    capsys.readouterr()
    assert set(jout) <= set(out)
    assert out["device"] == "cpu" and out["samples"] == 30 and out["levels"] == 2
    assert 1e-3 <= out["theta_EB"] <= 1.0 and np.isfinite(out["mse_db"])


def test_wavelet_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["--image", "synthetic", "--size", "32", "--samples", "5"])
    with pytest.raises(RuntimeError, match="cuda"):
        twl.run_sapg_wavelet_l1(synthetic_wheel(16), twl.WaveletL1Config(samples=5))
