"""Port vs JAX package: the power iteration (ops/lipschitz.py), the
profiling and TensorBoard tools (runtime/profiling.py,
runtime/tensorboard.py) and the CLI's results files and plots.

* `power_iteration` from JAX's normalised start: the same iteration count
  and λ within 1e-10 relative (float64), and within 1e-4 of the closed
  form, as tests/test_lipschitz.py holds JAX;
* CallCounter and MetricsLogger as tests/test_profiling.py checks them
  (the spans and counters: tests/test_torch_spans.py); the tfevents
  writer byte for byte against the JAX package's and through the real
  TensorBoard reader, as tests/test_tensorboard.py does; `trace` writes a
  Chrome trace;
* the CLI's `--out` writes traces.npz, and `--plots` the reference's PNG
  set (skipped only where matplotlib is absent).
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops import fourier as jfourier
from semiblind_tv_tpu.ops import lipschitz as jlip
from semiblind_tv_tpu.ops import psf as jpsf
from semiblind_tv_tpu.runtime import tensorboard as jtb
from semiblind_tv_tpu_torch.cli import run_demo as t_cli
from semiblind_tv_tpu_torch.ops import lipschitz as tlip
from semiblind_tv_tpu_torch.ops import psf as tpsf
from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.runtime import checkpoint as tck
from semiblind_tv_tpu_torch.runtime import profiling
from semiblind_tv_tpu_torch.runtime import tensorboard as ttb


@pytest.mark.parametrize("shape,tol", [((32, 32), 1e-7), ((24, 40), 1e-5)])
def test_power_iteration_matches_jax(shape, tol):
    jblur = jfourier.BlurOperator(shape, 7, jnp.float64)
    jH = jblur.otf(jpsf.gaussian_kernel(7, 0.4, 0.3, dtype=jnp.float64))
    jval, jiters = jlip.power_iteration(
        lambda x: jblur.apply_adjoint(jblur.apply(x, jH), jH), jax.random.key(0), shape, tol=tol)
    x0 = jax.random.normal(jax.random.key(0), shape)
    x0 = np.array(x0 / jnp.linalg.norm(x0))

    blur = BlurOperator(shape, 7, torch.float64, "cpu")
    H = blur.otf(tpsf.gaussian_kernel(7, 0.4, 0.3, dtype=torch.float64))
    val, iters = tlip.power_iteration(lambda x: blur.apply_adjoint(blur.apply(x, H), H), None,
                                      shape, tol=tol, x0=torch.from_numpy(x0))
    assert iters == int(jiters) > 1
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-10)
    np.testing.assert_allclose(float(val), float(tlip.max_eigenval_closed_form(H)), rtol=1e-3)


def test_power_iteration_from_a_generator_and_its_stop_rules():
    blur = BlurOperator((32, 32), 7, torch.float64, "cpu")
    H = blur.otf(tpsf.gaussian_kernel(7, 0.4, 0.3, dtype=torch.float64))

    def AtA(x):
        return blur.apply_adjoint(blur.apply(x, H), H)

    gen = torch.Generator().manual_seed(3)
    val, iters = tlip.power_iteration(AtA, gen, (32, 32), tol=1e-7, dtype=torch.float64)
    np.testing.assert_allclose(float(val), float(tlip.max_eigenval_closed_form(H)), rtol=1e-4)
    _, capped = tlip.power_iteration(AtA, torch.Generator().manual_seed(3), (32, 32), tol=1e-7,
                                     max_iter=5, dtype=torch.float64)
    assert capped == 5 < iters


def test_call_counter():
    reg = {}
    A = profiling.CallCounter(lambda v: v * 2, "A", reg)
    AT = profiling.CallCounter(lambda v: v / 2, "AT", reg)
    for _ in range(4):
        A(1.0)
    AT(2.0)
    assert reg == {"A": 4, "AT": 1}
    assert A.calls == 4


def test_metrics_logger(tmp_path):
    p = str(tmp_path / "metrics.jsonl")
    log = profiling.MetricsLogger(p)
    log.log(1, mse=np.float32(3.5), theta=0.01, sigma=torch.tensor(2.25))
    log.log(2, mse=3.2)
    log.close()
    lines = [json.loads(line) for line in open(p)]
    assert lines[0] == {"step": 1, "mse": 3.5, "theta": 0.01, "sigma": 2.25}
    assert lines[1]["step"] == 2


def test_tensorboard_writer_bytes_equal_jax(tmp_path, monkeypatch):
    """The copy writes the JAX writer's bytes (time and host name fixed)."""
    import socket
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    out = {}
    for name, mod in (("t", ttb), ("j", jtb)):
        with mod.TensorBoardWriter(str(tmp_path / name)) as w:
            w.add_scalar("loss", 1.5, step=1)
            w.add_scalar("theta/EB", 0.03125, step=2, wall_time=12.5)
        (path,) = glob.glob(str(tmp_path / name / "events.out.tfevents.*"))
        out[name] = (os.path.basename(path), open(path, "rb").read())
    assert out["t"] == out["j"]
    assert ttb._crc32c(b"123456789") == 0xE3069283


def _value_of(v):
    if v.HasField("tensor"):
        return v.tensor.float_val[0]
    return v.simple_value


def test_metrics_logger_tees_to_tensorboard(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    logdir = str(tmp_path / "tb")
    ml = profiling.MetricsLogger(str(tmp_path / "metrics.jsonl"), tensorboard_dir=logdir)
    ml.log(5, mse_db=27.5, label="not-a-scalar")
    ml.log(6, mse_db=torch.tensor(26.0))
    ml.close()
    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    events = list(EventFileLoader(path).Load())
    assert events[0].file_version == "brain.Event:2"
    scalars = [(e.step, v.tag, _value_of(v)) for e in events for v in e.summary.value]
    assert scalars == [(5, "mse_db", 27.5), (6, "mse_db", 26.0)]
    lines = open(tmp_path / "metrics.jsonl").read().strip().splitlines()
    assert len(lines) == 2 and "not-a-scalar" in lines[0]


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d) as prof:
        torch.fft.rfft2(torch.ones((1, 16, 16))).abs().sum()
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("fft" in n for n in names)
    assert any("fft" in e.key for e in prof.key_averages())


def _cli(out, *extra):
    return t_cli.main(["--device", "cpu", "--image", "synthetic", "--size", "24",
                       "--samples", "10", "--warmup", "3", "--out", str(out), *extra])


def test_cli_writes_traces_npz_with_the_fista_solver(tmp_path, capsys):
    res = _cli(tmp_path / "demo", "--solver", "fista")
    capsys.readouterr()
    saved = json.loads((tmp_path / "demo" / "results.json").read_text())
    assert saved == json.loads(json.dumps(res))
    assert saved["salsa_op_counts"] == {"A": 2 * saved["salsa_iters"], "AT": saved["salsa_iters"]}
    z = tck.load_results(str(tmp_path / "demo" / "traces.npz"))
    assert z["sapg/thetas"].shape == (10,) and "sapg/X_last" in z
    assert "salsa/objective" in z and "salsa/op_counts" not in z   # FISTAResult's fields
    assert float(z["sapg/scalar/theta_EB"]) == saved["theta_EB"]


def test_cli_plots_write_the_png_set(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    _cli(tmp_path / "demo", "--plots", "--psf", "laplace")
    capsys.readouterr()
    pngs = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "demo" / "*.png")))
    assert pngs == ["img_x.png", "img_xMAP.png", "img_y.png", "trace_b.png",
                    "trace_err_psf.png", "trace_logPi.png", "trace_sigma2.png",
                    "trace_theta.png"]


def test_save_plots_adds_the_posterior_panels(tmp_path):
    pytest.importorskip("matplotlib")
    import dataclasses

    from semiblind_tv_tpu_torch.runtime import config as tcfg
    from semiblind_tv_tpu_torch.utils.images import synthetic_wheel

    cfg = tcfg.isotropic_preset()
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=10, warmup=3, burn_in=6, track_posterior_moments=True),
        salsa=dataclasses.replace(cfg.salsa, outer_iters=5))
    results, sapg, salsa, problem = t_cli.run_demo(cfg, synthetic_wheel(24), device="cpu")
    t_cli.save_plots(str(tmp_path), results, sapg, salsa, problem)
    for name in ("img_posterior_mean.png", "img_posterior_std.png", "trace_w.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_plots_without_out_or_matplotlib_fail_before_the_run(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit):
        t_cli.main(["--device", "cpu", "--plots"])
    capsys.readouterr()
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(RuntimeError, match="matplotlib"):
        _cli(tmp_path / "demo", "--plots")
    assert not (tmp_path / "demo").exists()


def test_reference_images_sweep_aggregates(tmp_path):
    """benchmarks/run_reference_images (the JAX package's parity sweep): one
    results.json per image from run_demo, and run_stats' aggregate of them
    equal to the JAX package's run_stats on the same directory."""
    from PIL import Image

    from semiblind_tv_tpu.runtime.checkpoint import run_stats as j_run_stats
    from semiblind_tv_tpu_torch.benchmarks import run_reference_images

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        Image.fromarray((rng.random((32, 32)) * 255).astype(np.uint8)).save(imgs / f"{name}.png")
    out = tmp_path / "sweep"
    agg, per_image = run_reference_images.main([
        "--image-dir", str(imgs), "--images", "a,b", "--out", str(out), "--size", "32",
        "--samples", "6",
        "--warmup", "3", "--device", "cpu"])
    assert sorted(per_image) == ["a", "b"] and agg["count"] == 2.0
    for name, res in per_image.items():
        with open(out / name / "results.json") as f:
            assert json.load(f)["mse_db"] == res["mse_db"]
    assert agg == j_run_stats(str(out))
    with open(out / "aggregate.json") as f:
        assert json.load(f) == agg
