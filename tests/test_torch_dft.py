"""The port's dense-DFT transform mode and the steps that use it, against
the JAX package on the CPU (float64 unless stated).

* ops/fourier.py: rdft_matrices bit-equal to the JAX package's;
  rfft2_matmul/irfft2_matmul against JAX's (1e-12) and torch.fft (1e-10),
  even and odd widths, batched; BlurOperator in dft mode against JAX's.
* Kernels D and E: the plain versions against JAX myula_prox_tv_dft and
  myula_prox_tv_irdft in interpret mode, at 32² and 24×35, B = 2, within
  1e-10 relative (a sum or matmul order that differs at f64 is the only
  difference).
* The estimator in dft mode: 30-step trajectories against JAX run_sapg
  with fft_mode='dft' and the JAX draws (1e-8), and against the port's fft
  mode (1e-9); with route 'B' forced on CPU tensors, kernel D and kernel E
  (the wrappers' plain versions) equal the dft-mode trajectory, and the
  warm-up under fuse_irdft takes kernel B.
* The rules of resolve_fuse_dft / resolve_in_kernel_rng, and the CLI flags.
The in-kernel-noise estimator tests are in tests/test_torch_rng.py, the
dft-mode `run_demo` against JAX's in tests/test_torch_demo.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.ops import fourier as jf
from semiblind_tv_tpu.ops.fused_step_pallas import myula_prox_tv_dft as j_dft
from semiblind_tv_tpu.ops.fused_step_pallas import myula_prox_tv_irdft as j_irdft
from semiblind_tv_tpu.runtime import build_problem as j_build_problem
from semiblind_tv_tpu.runtime import config as jcfg
from semiblind_tv_tpu.sapg import run_sapg as j_run_sapg
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.cli import run_demo as t_cli
from semiblind_tv_tpu_torch.ops import fourier as tf
from semiblind_tv_tpu_torch.ops import fused_dft_cuda as fd
from semiblind_tv_tpu_torch.ops.psf import gaussian_kernel
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime.problem import build_problem, problem_from_arrays
from semiblind_tv_tpu_torch.sapg import estimator as est
from tests.test_torch_blocked import _rel
from tests.test_torch_sapg import jax_chain_draws, jax_problem_arrays, replay

SIZE = 32
SHAPES = [(32, 32), (24, 35), (16, 21)]


def _with(cfg, **sapg):
    return dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **sapg))


def _short(cfg, samples=30, warmup=5, **sapg):
    return _with(cfg, samples=samples, warmup=warmup, burn_in=(samples * 80) // 100, **sapg)


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rdft_matrices_bit_equal_to_jax(shape, dtype):
    t = tf.rdft_matrices(shape, getattr(torch, dtype))
    j = jf.rdft_matrices(shape, getattr(jnp, dtype))
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == getattr(torch, dtype) and t[k].is_contiguous()
        np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_matmul_transforms_match_jax_and_torch_fft(shape):
    rng = np.random.default_rng(0)
    mats_t, mats_j = tf.rdft_matrices(shape, torch.float64), jf.rdft_matrices(shape, jnp.float64)
    for x in (rng.standard_normal(shape), rng.standard_normal((3,) + shape)):
        got = tf.rfft2_matmul(torch.from_numpy(x), mats_t).numpy()
        np.testing.assert_allclose(got, np.asarray(jf.rfft2_matmul(jnp.asarray(x), mats_j)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, torch.fft.rfft2(torch.from_numpy(x)).numpy(),
                                   rtol=1e-10, atol=1e-10)
        # a general half-spectrum, as the hot loop feeds conj(H)·R̂
        half = x.shape[:-1] + (shape[1] // 2 + 1,)
        z = rng.standard_normal(half) + 1j * rng.standard_normal(half)
        got = tf.irfft2_matmul(torch.from_numpy(z), mats_t).numpy()
        np.testing.assert_allclose(got, np.asarray(jf.irfft2_matmul(jnp.asarray(z), mats_j)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, torch.fft.irfft2(torch.from_numpy(z), s=shape).numpy(),
                                   rtol=1e-10, atol=1e-11)


def test_blur_operator_dft_mode_matches_jax():
    rng = np.random.default_rng(1)
    shape = (24, 35)
    k = gaussian_kernel(7, 0.4, 0.3, 0.0, dtype=torch.float64)
    tb = tf.BlurOperator(shape, 7, torch.float64, fft_mode="dft")
    jb = jf.BlurOperator(shape, 7, jnp.float64, fft_mode="dft")
    assert tb.fft_mode == "dft" and tf.BlurOperator(shape, 7).rdft is None
    H = tb.otf(k)
    x = rng.standard_normal((2,) + shape)
    for t_op, j_op in ((tb.apply, jb.apply), (tb.apply_adjoint, jb.apply_adjoint)):
        got = t_op(torch.from_numpy(x), H).numpy()
        np.testing.assert_allclose(got, np.asarray(j_op(jnp.asarray(x), jnp.asarray(H.numpy()))),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        tf.BlurOperator(shape, 7, fft_mode="fast")


# ---------------------------------------------------------------------------
# Kernels D and E: plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

def _dft_inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    B, M, N = shape
    x = rng.random(shape) * 100
    prox = x + rng.standard_normal(shape) * 0.1
    z = rng.standard_normal(shape)
    half = (B, M, N // 2 + 1)
    ghat = (rng.standard_normal(half) + 1j * rng.standard_normal(half)) * 50.0
    return ghat, x, prox, z


@pytest.mark.parametrize("shape", [(2, 32, 32), (2, 24, 35)])
@pytest.mark.parametrize("kernel", ["D", "E"])
def test_dft_kernels_plain_match_jax_interpret(shape, kernel):
    ghat, x, prox, z = _dft_inputs(shape)
    mats_t = tf.rdft_matrices(shape[1:], torch.float64)
    mats_j = jf.rdft_matrices(shape[1:], jnp.float64)
    sc = (0.03, 0.9, 0.04, 2.5)
    t_fn, j_fn = (fd.myula_prox_tv_dft, j_dft) if kernel == "D" else (fd.myula_prox_tv_irdft,
                                                                      j_irdft)
    for tol, positivity in ((0.0, True), (1e-3, False)):
        kw = dict(n_sweeps=25, tol=tol, positivity=positivity)
        t = t_fn(*(torch.from_numpy(a) for a in (ghat, x, prox, z)), mats_t, *sc, **kw)
        j = j_fn(*(jnp.asarray(a) for a in (ghat, x, prox, z)), mats_j, *sc, interpret=True,
                 **kw)
        assert len(t) == len(j) == (4 if kernel == "D" else 3)
        for name, u, v in zip(("xn", "proxn", "tv", "xhat"), t, j):
            assert _rel(u.numpy(), np.asarray(v)) <= 1e-10, name
    # the plain version's optional sweep counts
    it = t_fn(*(torch.from_numpy(a) for a in (ghat, x, prox, z)), mats_t, *sc, n_sweeps=7,
              tol=0.0, return_iters=True)[-1]
    assert it.tolist() == [7, 7]


# ---------------------------------------------------------------------------
# The estimator in dft mode
# ---------------------------------------------------------------------------

def _jax_and_port_problems(family, kw, **sapg):
    jc = _short(jcfg.preset(family, **kw), **sapg)
    tc = _short(tcfg.preset(family, **kw), **sapg)
    x = synthetic_wheel(SIZE)
    jp = j_build_problem(x, jc, jax.random.key(1), dtype=jnp.float64)
    tp = problem_from_arrays(tc, jax_problem_arrays(jp), device="cpu", dtype=torch.float64,
                             fft_mode=jp.blur.fft_mode)
    return jc, jp, tp, x


@pytest.mark.parametrize("family,n_chains", [("gaussian", 1), ("moffat", 2)])
def test_dft_trajectory_matches_jax(family, n_chains):
    kw = dict(fix_w1=False, fix_w2=False) if family == "gaussian" else {}
    jc, jp, tp, x = _jax_and_port_problems(family, kw, fft_mode="dft")
    assert jp.blur.fft_mode == tp.blur.fft_mode == "dft"
    for k, m in jp.blur._rdft.items():
        np.testing.assert_array_equal(tp.blur.rdft[k].numpy(), m, err_msg=k)
    jr = j_run_sapg(jp, jax.random.key(2), n_chains=n_chains)
    n_steps = (jc.sapg.warmup - 1) + (jc.sapg.samples - 1)
    draws = jax_chain_draws(jax.random.key(2), n_chains, x.shape, n_steps)
    tr = est.run_sapg(tp, n_chains=n_chains, noise=replay(draws))
    for name in ("thetas", "sigma2s", "logPiTrace", "logPiTrace_warmup", "gX"):
        np.testing.assert_allclose(getattr(tr, name), getattr(jr, name), rtol=1e-8,
                                   err_msg=name)
    for n in jr.psf_param_traces:
        np.testing.assert_allclose(tr.psf_param_traces[n], jr.psf_param_traces[n], rtol=1e-8)
    np.testing.assert_allclose(tr.X_last, np.asarray(jr.X_last), rtol=1e-8, atol=1e-8)


def _port_run(cfg, route=None, noise_seed=2, n_chains=1, **kw):
    """A 30-step port run on a 32² wheel with numpy draws (float64)."""
    x = synthetic_wheel(SIZE)
    obs = np.random.default_rng(0).standard_normal(x.shape)
    problem = build_problem(x, cfg, dtype=torch.float64, device="cpu", noise=obs)
    rng = np.random.default_rng(noise_seed)
    draws = [rng.standard_normal((n_chains,) + x.shape) for _ in range(40)]
    return est.run_sapg(problem, n_chains=n_chains, noise=replay(draws), route=route, **kw)


def test_dft_mode_matches_fft_mode():
    base = _short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False))
    r_fft = _port_run(base)
    r_dft = _port_run(_with(base, fft_mode="dft"))
    np.testing.assert_allclose(r_dft.thetas, r_fft.thetas, rtol=1e-9)
    np.testing.assert_allclose(r_dft.sigma2s, r_fft.sigma2s, rtol=1e-9)
    for n in r_fft.psf_param_traces:
        np.testing.assert_allclose(r_dft.psf_param_traces[n], r_fft.psf_param_traces[n],
                                   rtol=1e-9)
    np.testing.assert_allclose(r_dft.X_last, r_fft.X_last, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("option,counter", [
    (dict(fuse_dft=True), "D"), (dict(fuse_dft=None), "D"),
    (dict(fuse_dft=False, fuse_irdft=True), "E"),
])
def test_forced_route_b_dft_kernels_equal_the_dft_trajectory(monkeypatch, option, counter):
    """On CPU tensors the D and E wrappers run their plain versions: the
    estimator's kernel branches (D: 32² and one chain, so the auto rule
    picks it too; E: the main steps only, the warm-up through kernel B)
    must give the dft-mode trajectory."""
    base = _short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False), fft_mode="dft")
    calls = {"D": 0, "E": 0, "B": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(est, "myula_prox_tv_dft", spy("D", est.myula_prox_tv_dft))
    monkeypatch.setattr(est, "myula_prox_tv_irdft", spy("E", est.myula_prox_tv_irdft))
    monkeypatch.setattr(est, "myula_prox_tv", spy("B", est.myula_prox_tv))
    ref = _port_run(_with(base, fuse_dft=False), route="B")
    assert calls == {"D": 0, "E": 0, "B": 4 + 29}
    calls.update(D=0, E=0, B=0)
    res = _port_run(_with(base, **option), route="B")
    if counter == "D":
        assert calls == {"D": 4 + 29, "E": 0, "B": 0}
    else:
        assert calls == {"D": 0, "E": 29, "B": 4}
    for name in ("thetas", "sigma2s", "logPiTrace", "logPiTrace_warmup"):
        np.testing.assert_allclose(getattr(res, name), getattr(ref, name), rtol=1e-10,
                                   err_msg=name)
    np.testing.assert_allclose(res.X_last, ref.X_last, rtol=1e-10, atol=1e-10)


_SAPG = tcfg.SAPGConfig()


@pytest.mark.parametrize("route,fft_mode,size,B,opts,fuse,ikr", [
    # the auto rule of kernel D: ≤256² and ≤2 chains, dft mode, route B
    ("B", "dft", 256, 2, {}, True, False),
    ("B", "dft", 256, 3, {}, False, False),
    ("B", "dft", 512, 1, {}, False, False),
    ("B", "fft", 128, 1, {}, False, False),
    ("B", "dft", 512, 16, dict(fuse_dft=True), True, False),
    ("B", "dft", 128, 1, dict(fuse_dft=False), False, False),
    ("B", "dft", 128, 1, dict(use_fused_step=False, fuse_dft=True), False, False),
    ("plain", "dft", 128, 1, dict(fuse_dft=True), False, False),
    ("G", "dft", 1024, 1, dict(fuse_dft=True), False, False),
    # in-kernel noise: routes B and I, fused, not under kernel D
    ("B", "fft", 512, 16, dict(in_kernel_rng=True), False, True),
    ("B", "dft", 256, 2, dict(in_kernel_rng=True), True, False),
    ("B", "dft", 256, 2, dict(in_kernel_rng=True, fuse_dft=False), False, True),
    ("I", "fft", 2048, 1, dict(in_kernel_rng=True), False, True),
    ("G", "fft", 1024, 4, dict(in_kernel_rng=True), False, False),
    ("plain", "fft", 512, 1, dict(in_kernel_rng=True), False, False),
    ("B", "fft", 512, 1, dict(in_kernel_rng=True, use_fused_step=False), False, False),
    ("I", "fft", 2048, 1, {}, False, False),
])
def test_resolve_rules(route, fft_mode, size, B, opts, fuse, ikr):
    sapg = dataclasses.replace(_SAPG, **opts)
    assert est.resolve_fuse_dft(sapg, route, fft_mode, (size, size), B) is fuse
    assert est.resolve_in_kernel_rng(sapg, route, fft_mode, (size, size), B) is ikr


def test_cli_fft_mode_and_in_kernel_rng_flags(tmp_path):
    out = tmp_path / "demo"
    res = t_cli.main(["--device", "cpu", "--image", "synthetic", "--size", "32",
                      "--samples", "10", "--warmup", "4", "--fft-mode", "dft",
                      "--in-kernel-rng", "--out", str(out)])
    assert np.isfinite(res["theta_EB"]) and np.isfinite(res["sigma2_EB"])
    assert (out / "results.json").exists()
    with pytest.raises(SystemExit):
        t_cli.main(["--device", "cpu", "--fft-mode", "fast"])
