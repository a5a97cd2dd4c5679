"""Port vs JAX package: the row-split spatial path (parallel/spatial.py).

Every case of tests/test_spatial.py at S=2: the JAX functions run here on
two devices of conftest.py's virtual CPU mesh, the port's in a 2-process
gloo world on the CPU (runtime/distributed.spawn, once for the module; a
60 s timeout on every group; the workers import no jax), on the same
inputs, held to the tolerances of tests/test_spatial.py: the halo-exchanged
stencils, the prox, the reduce-scattered transforms, the blur, the MYULA
step, SALSA and the whole SAPG estimator (fed the JAX draws); then the
port's own checkpoint/resume and NaN guard (directory backend across the
two processes) and `run_demo --space-mesh 2 --device cpu`, which starts its
two gloo processes itself.  float64.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime.distributed import spawn

M = N = 64
S = 2


def _cfg(samples, warmup, burn_in):
    cfg = tcfg.gaussian_preset(fix_w1=False, fix_w2=False)
    return dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=samples, warmup=warmup, burn_in=burn_in, fft_mode="dft"))


def _world(rank, case_dir):
    from semiblind_tv_tpu_torch.ops.fourier import rdft_matrices
    from semiblind_tv_tpu_torch.parallel import spatial
    from semiblind_tv_tpu_torch.parallel.mesh import SPACE_AXIS, make_spatial_mesh
    from semiblind_tv_tpu_torch.runtime.problem import problem_from_arrays

    mesh = make_spatial_mesh(S, device_type="cpu")
    g = mesh.get_group(SPACE_AXIS)
    z = np.load(os.path.join(case_dir, "inputs.npz"))
    T = {k: torch.from_numpy(z[k]) for k in z.files}
    rows = spatial.shard_rows
    out = {}

    def whole(x):
        return spatial.unshard_rows(x, g).numpy()

    img = T["img"]
    out["tv"] = float(spatial.spatial_tv_norm(rows(img, g), g))
    p1, p2 = img / 255.0, torch.flipud(img) / 255.0
    out["div"] = whole(spatial.spatial_divergence(rows(p1, g), rows(p2, g), g))
    gx, gy = spatial.spatial_forward_gradient(rows(p1, g), g)
    out["grad"] = (whole(gx), whole(gy))
    f, (px, py, k, err) = spatial.spatial_chambolle_prox(rows(img, g), 0.05, 25, group=g)
    out["prox"] = (whole(f), whole(px), int(k), float(err))
    mats = rdft_matrices((M, N), torch.float64)
    zre, zim = spatial.spatial_rfft2(rows(img, g), mats, g)
    out["rfft"] = (whole(zre), whole(zim), whole(spatial.spatial_irfft2(zre, zim, mats, g)))
    Hre, Him = rows(T["H_re"], g), rows(T["H_im"], g)
    out["blur"] = tuple(whole(spatial.spatial_blur_apply(rows(img, g), Hre, Him, mats, g,
                                                         adjoint=a)) for a in (False, True))
    out["myula"] = whole(spatial.spatial_myula_step(
        rows(img, g), rows(img * 0.9, g), rows(T["z"], g), Hre, Him, rows(T["yh_re"], g),
        rows(T["yh_im"], g), mats, 1.5, 2.0, 4.0, g))
    H = torch.complex(T["H_re"], T["H_im"])
    x, objs, n_it = spatial.spatial_salsa_tv(T["y_salsa"], H, 0.08, 0.008, mesh, max_iter=60,
                                             tol=1e-5, tv_iters=10, dtype=torch.float64)
    out["salsa"] = (x.numpy(), objs, n_it)

    # the estimator, fed the JAX draws
    arrays = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    arrays["sigma2_box"] = (z["box_lo"], z["box_hi"])
    problem = problem_from_arrays(_cfg(40, 20, 32), arrays, device="cpu", dtype=torch.float64,
                                  fft_mode="dft")
    draws = iter(z["draws"])
    res = spatial.run_sapg_spatial(problem, mesh, noise=lambda shape: torch.from_numpy(next(draws)))
    out["sapg"] = dict(thetas=res.thetas, sigma2s=res.sigma2s, psf=res.psf_param_traces,
                       logPiTrace=res.logPiTrace, logPiTrace_warmup=res.logPiTrace_warmup,
                       X_last=res.X_last, theta_EB=res.theta_EB)

    # the port's own checkpoint/resume and NaN guard (directory backend)
    short = dataclasses.replace(problem, cfg=_cfg(24, 10, 20))

    def run(seed, **kw):
        return spatial.run_sapg_spatial(short, mesh, torch.Generator().manual_seed(seed), **kw)

    full = run(6)
    ck = os.path.join(case_dir, "spatial")
    seg = run(6, checkpoint_every=7, checkpoint_path=ck, checkpoint_backend="orbax")
    resumed = run(60, checkpoint_every=7, checkpoint_path=ck, checkpoint_backend="orbax")
    out["resume"] = [(r.thetas, r.X_last, r.logPiTrace_warmup) for r in (full, seg, resumed)]
    hits = []

    def fault(seg_idx, carry):
        if seg_idx == 2 and not hits:
            hits.append(seg_idx)
            return (carry[0] * float("nan"),) + tuple(carry[1:])
        return carry

    guarded = run(6, checkpoint_every=7, checkpoint_path=os.path.join(case_dir, "guard"),
                  checkpoint_backend="orbax", fault_hook=fault)
    out["nan_guard"] = (guarded.thetas, full.thetas, list(hits))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from semiblind_tv_tpu.ops import fourier
    from semiblind_tv_tpu.ops.psf import gaussian_kernel
    from semiblind_tv_tpu.parallel import spatial as js
    from semiblind_tv_tpu.parallel.mesh import make_spatial_mesh
    from semiblind_tv_tpu.runtime import build_problem, gaussian_preset
    from semiblind_tv_tpu.utils import synthetic_wheel
    from tests.test_torch_sapg import jax_chain_draws, jax_problem_arrays

    dt = jnp.float64
    mesh = make_spatial_mesh(S)
    ax = mesh.axis_names[0]
    row = P(ax, None)

    def smap(fn, n_in, out_spec):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(row,) * n_in, out_specs=out_spec))

    img = jax.random.uniform(jax.random.key(0), (M, N), dt) * 255.0
    p1, p2 = img / 255.0, jnp.flipud(img) / 255.0
    mats = fourier.rdft_matrices((M, N), dt)
    blur = fourier.BlurOperator((M, N), 7, dt, fft_mode="dft")
    H = blur.otf_host(gaussian_kernel(7, 0.4, 0.3, dtype=dt))
    Hre, Him = jnp.asarray(H.real, dt), jnp.asarray(H.imag, dt)
    y = jax.jit(lambda x: blur.apply(x, jnp.asarray(H)))(img)
    yh = fourier.rfft2_matmul(y, mats)
    z = jax.random.normal(jax.random.key(3), (M, N), dt)
    y_salsa = y + 2.0 * jax.random.normal(jax.random.key(9), (M, N), dt)

    ref = {"tv": float(smap(js.spatial_tv_norm, 1, P())(img))}
    ref["div"] = np.asarray(smap(js.spatial_divergence, 2, row)(p1, p2))
    ref["grad"] = tuple(np.asarray(v) for v in smap(js.spatial_forward_gradient, 1,
                                                    (row, row))(p1))
    f, px, py, k, err = smap(lambda g: (lambda r: (r[0],) + tuple(r[1]))(
        js.spatial_chambolle_prox(g, 0.05, 25)), 1, (row, row, row, P(), P()))(img)
    ref["prox"] = (np.asarray(f), np.asarray(px), int(k), float(err))
    zre, zim = smap(lambda x: js.spatial_rfft2(x, mats), 1, (row, row))(img)
    back = smap(lambda a, b: js.spatial_irfft2(a, b, mats), 2, row)(zre, zim)
    ref["rfft"] = (np.asarray(zre), np.asarray(zim), np.asarray(back))
    ref["blur"] = tuple(np.asarray(v) for v in smap(
        lambda x, hr, hi: (js.spatial_blur_apply(x, hr, hi, mats),
                           js.spatial_blur_apply(x, hr, hi, mats, adjoint=True)),
        3, (row, row))(img, Hre, Him))
    ref["myula"] = np.asarray(smap(
        lambda x, p, zz, hr, hi, yr, yi: js.spatial_myula_step(x, p, zz, hr, hi, yr, yi, mats,
                                                               1.5, 2.0, 4.0),
        7, row)(img, img * 0.9, z, Hre, Him, jnp.asarray(np.asarray(yh.real)),
                jnp.asarray(np.asarray(yh.imag))))
    x_sp, objs, n_it = js.spatial_salsa_tv(y_salsa, H, 0.08, 0.008, mesh, max_iter=60, tol=1e-5,
                                           tv_iters=10, dtype=dt)
    ref["salsa"] = (np.asarray(x_sp), objs, n_it)

    cfg = gaussian_preset(fix_w1=False, fix_w2=False)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=40, warmup=20, burn_in=32, fft_mode="dft"))
    problem = build_problem(synthetic_wheel(M), cfg, jax.random.key(5), dtype=dt)
    key = jax.random.key(6)
    ref["sapg"] = js.run_sapg_spatial(problem, mesh, key)

    case_dir = str(tmp_path_factory.mktemp("spatial"))
    arrays = jax_problem_arrays(problem)
    lo, hi = arrays.pop("sigma2_box")
    draws = jax_chain_draws(key, 1, (M, N), (cfg.sapg.warmup - 1) + (cfg.sapg.samples - 1))
    np.savez(os.path.join(case_dir, "inputs.npz"), img=np.asarray(img), H_re=np.asarray(Hre),
             H_im=np.asarray(Him), z=np.asarray(z), yh_re=np.asarray(yh.real),
             yh_im=np.asarray(yh.imag), y_salsa=np.asarray(y_salsa), box_lo=lo, box_hi=hi,
             draws=np.stack(draws), **{f"p_{k}": v for k, v in arrays.items()})
    port = spawn(_world, S, (case_dir,), timeout=60)
    return ref, port[0]


def test_spatial_tv_norm(worlds):
    ref, got = worlds
    np.testing.assert_allclose(got["tv"], ref["tv"], rtol=1e-13)


def test_spatial_stencils(worlds):
    ref, got = worlds
    np.testing.assert_allclose(got["div"], ref["div"], atol=1e-14)
    for a, b in zip(got["grad"], ref["grad"]):
        np.testing.assert_allclose(a, b, atol=1e-14)


def test_spatial_chambolle_prox(worlds):
    ref, got = worlds
    for a, b in zip(got["prox"][:2], ref["prox"][:2]):
        np.testing.assert_allclose(a, b, atol=1e-12)
    assert got["prox"][2] == ref["prox"][2]
    np.testing.assert_allclose(got["prox"][3], ref["prox"][3], rtol=1e-10)


def test_spatial_transforms_roundtrip(worlds):
    ref, got = worlds
    for a, b in zip(got["rfft"], ref["rfft"]):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_spatial_blur_apply(worlds):
    ref, got = worlds
    for a, b in zip(got["blur"], ref["blur"]):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_spatial_myula_step(worlds):
    ref, got = worlds
    np.testing.assert_allclose(got["myula"], ref["myula"], atol=1e-9)


def test_spatial_salsa(worlds):
    ref, got = worlds
    (x, objs, n_it), (rx, robjs, rn) = got["salsa"], ref["salsa"]
    assert n_it == rn
    np.testing.assert_allclose(x, rx, atol=1e-10)
    np.testing.assert_allclose(objs[:n_it], robjs[:n_it], rtol=1e-12)


def test_spatial_sapg_matches_jax(worlds):
    ref, got = worlds
    r, g = ref["sapg"], got["sapg"]
    for k in ("thetas", "sigma2s", "logPiTrace", "logPiTrace_warmup"):
        np.testing.assert_allclose(g[k], getattr(r, k), rtol=1e-9)
    for n in r.psf_param_traces:
        np.testing.assert_allclose(g["psf"][n], r.psf_param_traces[n], rtol=1e-9)
    np.testing.assert_allclose(g["X_last"], r.X_last, atol=1e-9)
    assert abs(g["theta_EB"] - r.theta_EB) < 1e-9


def test_spatial_sapg_checkpoint_resume(worlds):
    (full, seg, resumed) = worlds[1]["resume"]
    np.testing.assert_allclose(seg[0], full[0], rtol=1e-12)
    np.testing.assert_allclose(seg[1], full[1], atol=1e-12)
    np.testing.assert_allclose(resumed[0], full[0], rtol=1e-12)
    np.testing.assert_allclose(resumed[2], full[2], rtol=1e-12)


def test_spatial_sapg_nan_guard_recovers(worlds):
    guarded, full, hits = worlds[1]["nan_guard"]
    assert hits == [2]
    np.testing.assert_allclose(guarded, full, rtol=1e-12)


def test_space_mesh_cli_flag(tmp_path):
    """`run_demo --space-mesh 2 --device cpu` runs the SAPG phase through
    run_sapg_spatial in two gloo processes it starts itself."""
    from semiblind_tv_tpu_torch.cli.run_demo import main

    results = main(["--psf", "gaussian", "--image", "synthetic", "--size", "32",
                    "--samples", "6", "--warmup", "4", "--space-mesh", "2", "--device", "cpu",
                    "--out", str(tmp_path)])
    assert np.isfinite(results["theta_EB"]) and np.isfinite(results["mse_db"])
    assert results["space_mesh"] == 2
    assert (tmp_path / "results.json").exists()
