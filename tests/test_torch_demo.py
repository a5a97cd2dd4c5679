"""The whole slice: the port's `run_demo` against the JAX package's
`run_demo` at 32² (Gaussian, w free, warm-up 20, 40 samples, 50 SALSA
iterations), float64, with the JAX observation noise and chain noise
injected into the port; and the port's CLI on the CPU.

θ_EB, σ²_EB, the PSF parameters and mse_db agree to 1e-8 relative; SSIM,
which both packages compute in float32 with L=1 on [0, 255] data, to 1e-3
(see tests/test_torch_salsa_metrics.py::test_ssim_matches_jax).  The same
comparison runs in the dense-DFT transform mode (fft_mode='dft').
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semiblind_tv_tpu.cli.run_demo import run_demo as j_run_demo
from semiblind_tv_tpu.runtime import config as jcfg
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.cli import run_demo as t_cli
from semiblind_tv_tpu_torch.runtime import config as tcfg
from tests.test_torch_sapg import jax_chain_draws, replay

SIZE = 32
RTOL = 1e-8


def _short(cfg):
    return dataclasses.replace(
        cfg,
        sapg=dataclasses.replace(cfg.sapg, samples=40, warmup=20, burn_in=32),
        salsa=dataclasses.replace(cfg.salsa, outer_iters=50),
    )


def test_run_demo_matches_jax_run_demo():
    jc = _short(jcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    tc = _short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    img = synthetic_wheel(SIZE)
    jr, js, jsal, _ = j_run_demo(jc, img, dtype=jnp.float64)

    # the JAX run's draws: y from k_prob (build_problem), chains from k_sapg
    k_prob, k_sapg = jax.random.split(jax.random.key(jc.seed))
    obs = np.asarray(jax.random.normal(k_prob, img.shape, jnp.float64))
    draws = jax_chain_draws(k_sapg, 1, img.shape, (20 - 1) + (40 - 1))
    tr, ts, tsal, tp = t_cli.run_demo(tc, img, dtype=torch.float64, device="cpu",
                                      obs_noise=obs, noise=replay(draws))

    for k in ("theta_EB", "sigma2_EB", "mse_db", "psnr_db", "snr_db", "mse_db_observation",
              "sigma2_true", "lambda", "gamma", "Lf", "ev_max"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=RTOL, err_msg=k)
    for k, v in jr["psf_params_EB"].items():
        np.testing.assert_allclose(tr["psf_params_EB"][k], v, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(tr["ssim"], jr["ssim"], rtol=1e-3)
    assert tr["salsa_iters"] == jr["salsa_iters"]
    assert tr["salsa_op_counts"] == jr["salsa_op_counts"]
    np.testing.assert_allclose(ts.thetas, js.thetas, rtol=RTOL)
    np.testing.assert_allclose(tsal.x, np.asarray(jsal.x), rtol=RTOL, atol=1e-8)
    assert tr["mse_db"] < tr["mse_db_observation"]


def test_cli_main_on_cpu_writes_results(tmp_path, capsys):
    out = tmp_path / "demo"
    res = t_cli.main(["--device", "cpu", "--image", "synthetic", "--size", "32",
                      "--samples", "12", "--warmup", "4", "--chains", "2", "--out", str(out)])
    saved = json.loads((out / "results.json").read_text())
    assert saved["n_chains"] == 2 and saved["samples"] == 12
    assert np.isfinite(saved["theta_EB"]) and saved["device"] == "cpu"
    assert json.loads(capsys.readouterr().out) == saved == json.loads(json.dumps(res))


def test_run_demo_dft_mode_matches_jax_run_demo():
    def short(cfg):
        return dataclasses.replace(
            cfg, sapg=dataclasses.replace(cfg.sapg, samples=40, warmup=20, burn_in=32,
                                          fft_mode="dft"),
            salsa=dataclasses.replace(cfg.salsa, outer_iters=50))

    jc = short(jcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    tc = short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    img = synthetic_wheel(SIZE)
    jr, js, jsal, _ = j_run_demo(jc, img, dtype=jnp.float64)
    k_prob, k_sapg = jax.random.split(jax.random.key(jc.seed))
    obs = np.asarray(jax.random.normal(k_prob, img.shape, jnp.float64))
    draws = jax_chain_draws(k_sapg, 1, img.shape, (20 - 1) + (40 - 1))
    tr, ts, tsal, tp = t_cli.run_demo(tc, img, dtype=torch.float64, device="cpu",
                                      obs_noise=obs, noise=replay(draws))
    assert tp.blur.fft_mode == "dft"
    for k in ("theta_EB", "sigma2_EB", "mse_db", "psnr_db", "snr_db", "mse_db_observation"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-8, err_msg=k)
    np.testing.assert_allclose(ts.sigma2s, js.sigma2s, rtol=1e-8)
    np.testing.assert_allclose(tsal.x, np.asarray(jsal.x), rtol=1e-8, atol=1e-8)
