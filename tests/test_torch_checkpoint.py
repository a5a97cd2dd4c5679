"""Port vs JAX package: checkpoint, resume and the NaN-guard restore of the
SAPG estimator, and the results files (runtime/checkpoint.py).

* a run interrupted after a checkpoint and resumed equals the uninterrupted
  run (rtol 1e-12, float64), on the generator path (the checkpoint holds
  the torch.Generator's state, so the resume may pass a differently seeded
  generator), with the in-kernel noise through kernel C's plain version,
  with the posterior moments, with Xhat recomputed from a file without its
  planes, and after the final checkpoint;
* a segmented port run fed the JAX draws equals JAX `run_sapg` (the RTOL of
  tests/test_torch_sapg.py), also when it is interrupted and resumed with
  the replay positioned at the checkpoint;
* a NaN injected into the carry restores from the checkpoint and ends on
  the clean run; without a checkpoint, and with the restores used up, the
  run raises SAPGDivergenceError; the Orbax backend raises;
* save_results / load_results / run_stats give the JAX package's keys and
  values on the same results.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semiblind_tv_tpu.runtime import build_problem as j_build_problem
from semiblind_tv_tpu.runtime import checkpoint as jck
from semiblind_tv_tpu.runtime import config as jcfg
from semiblind_tv_tpu.sapg import run_sapg as j_run_sapg
from semiblind_tv_tpu.utils import synthetic_wheel
from semiblind_tv_tpu_torch.runtime import checkpoint as tck
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime.problem import build_problem, problem_from_arrays
from semiblind_tv_tpu_torch.sapg.estimator import SAPGDivergenceError, run_sapg
from tests.test_torch_sapg import RTOL, jax_chain_draws, jax_problem_arrays, replay

SIZE = 32
EXACT = 1e-12
EVERY = 7


class Preempted(Exception):
    """Stands for the process being killed between two segments."""


def _cfg(samples=30, warmup=5, **sapg):
    cfg = tcfg.gaussian_preset(fix_w1=False, fix_w2=False)
    return dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=samples, warmup=warmup, burn_in=(samples * 80) // 100, **sapg))


def _problem(cfg):
    return build_problem(synthetic_wheel(SIZE), cfg, torch.Generator().manual_seed(1),
                         dtype=torch.float64, device="cpu")


def _preempt_before(seg):
    def hook(seg_idx, carry):
        if seg_idx == seg:
            raise Preempted()
        return carry
    return hook


def _nan_once(seg, fired):
    def hook(seg_idx, carry):
        if seg_idx == seg and not fired:
            fired.append(seg_idx)
            X = carry[0].clone()
            X[0, 0, 0] = float("nan")
            return (X,) + tuple(carry[1:])
        return carry
    return hook


def _assert_same_run(a, b, rtol=EXACT):
    np.testing.assert_allclose(a.thetas, b.thetas, rtol=rtol)
    np.testing.assert_allclose(a.sigma2s, b.sigma2s, rtol=rtol)
    for n in b.psf_param_traces:
        np.testing.assert_allclose(a.psf_param_traces[n], b.psf_param_traces[n], rtol=rtol)
    np.testing.assert_allclose(a.logPiTrace, b.logPiTrace, rtol=rtol)
    np.testing.assert_allclose(a.logPiTrace_warmup, b.logPiTrace_warmup, rtol=rtol)
    np.testing.assert_allclose(a.gX, b.gX, rtol=rtol)
    np.testing.assert_allclose(a.X_last, np.asarray(b.X_last), rtol=rtol, atol=1e-12)
    assert a.theta_EB == pytest.approx(b.theta_EB, rel=rtol)


@pytest.mark.parametrize("sapg,route", [
    ({}, None),
    (dict(in_kernel_rng=True), "B"),            # kernel C's plain version, seeds drawn
    (dict(track_posterior_moments=True), None),
], ids=["generator", "kernel-C-seeds", "moments"])
def test_resume_equals_uninterrupted_run(tmp_path, sapg, route):
    problem = _problem(_cfg(**sapg))
    full = run_sapg(problem, torch.Generator().manual_seed(2), route=route)
    ckpt = str(tmp_path / "sapg.npz")
    with pytest.raises(Preempted):
        run_sapg(problem, torch.Generator().manual_seed(2), route=route,
                 checkpoint_every=EVERY, checkpoint_path=ckpt, fault_hook=_preempt_before(2))
    z = tck.load_checkpoint_arrays(ckpt)
    assert int(z["done_iters"]) == 2 * EVERY and z["generator_state"].dtype == np.uint8
    # another seed: the resume sets the saved state, it never reseeds
    resumed = run_sapg(problem, torch.Generator().manual_seed(77), route=route,
                       checkpoint_every=EVERY, checkpoint_path=ckpt)
    _assert_same_run(resumed, full)
    if sapg.get("track_posterior_moments"):
        np.testing.assert_allclose(resumed.posterior_mean, full.posterior_mean, rtol=EXACT)
        np.testing.assert_allclose(resumed.posterior_var, full.posterior_var, rtol=EXACT)


def test_resume_skips_the_warm_up(tmp_path, monkeypatch):
    """A resumed run calls no warm-up step and no initial prox."""
    from semiblind_tv_tpu_torch.sapg import estimator

    problem = _problem(_cfg())
    ckpt = str(tmp_path / "sapg.npz")
    with pytest.raises(Preempted):
        run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=EVERY,
                 checkpoint_path=ckpt, fault_hook=_preempt_before(1))
    calls = []
    real = estimator.make_general_sapg_step

    def counting(*a, **k):
        step, aux = real(*a, **k)
        warm, prox_b = aux["warm_step"], aux["prox_b"]
        aux["warm_step"] = lambda *x: calls.append("warm") or warm(*x)
        aux["prox_b"] = lambda *x: calls.append("prox") or prox_b(*x)
        return lambda *x: calls.append("step") or step(*x), aux

    monkeypatch.setattr(estimator, "make_general_sapg_step", counting)
    run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=EVERY,
             checkpoint_path=ckpt)
    assert calls == ["step"] * (problem.cfg.sapg.samples - 1 - EVERY)


def test_resume_after_the_final_checkpoint_rebuilds_the_full_trace(tmp_path):
    problem = _problem(_cfg())
    full = run_sapg(problem, torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "sapg.npz")
    seg = run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=EVERY,
                   checkpoint_path=ckpt)
    _assert_same_run(seg, full)
    again = run_sapg(problem, torch.Generator().manual_seed(5), checkpoint_every=EVERY,
                     checkpoint_path=ckpt)
    _assert_same_run(again, full)
    assert len(again.thetas) == problem.cfg.sapg.samples


def test_resume_recomputes_xhat_from_a_file_without_its_planes(tmp_path):
    problem = _problem(_cfg())
    full = run_sapg(problem, torch.Generator().manual_seed(2))
    ckpt = str(tmp_path / "sapg.npz")
    with pytest.raises(Preempted):
        run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=EVERY,
                 checkpoint_path=ckpt, fault_hook=_preempt_before(2))
    z = tck.load_checkpoint_arrays(ckpt)
    tck.save_checkpoint_arrays(ckpt, {k: v for k, v in z.items() if not k.startswith("Xhat")})
    resumed = run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=EVERY,
                       checkpoint_path=ckpt)
    _assert_same_run(resumed, full)


def _jax_pair(cfg_t):
    jc = jcfg.gaussian_preset(fix_w1=False, fix_w2=False)
    jc = dataclasses.replace(jc, sapg=dataclasses.replace(
        jc.sapg, samples=cfg_t.sapg.samples, warmup=cfg_t.sapg.warmup,
        burn_in=cfg_t.sapg.burn_in))
    jp = j_build_problem(synthetic_wheel(SIZE), jc, jax.random.key(1), dtype=jnp.float64)
    tp = problem_from_arrays(cfg_t, jax_problem_arrays(jp), device="cpu", dtype=torch.float64)
    return jp, tp


def test_segmented_run_with_jax_draws_matches_jax(tmp_path):
    cfg = _cfg()
    jp, tp = _jax_pair(cfg)
    jr = j_run_sapg(jp, jax.random.key(2), checkpoint_every=EVERY,
                    checkpoint_path=str(tmp_path / "jax.npz"))
    n_warm = cfg.sapg.warmup - 1
    draws = jax_chain_draws(jax.random.key(2), 1, (SIZE, SIZE), n_warm + cfg.sapg.samples - 1)
    ckpt = str(tmp_path / "port.npz")
    tr = run_sapg(tp, noise=replay(draws), checkpoint_every=EVERY, checkpoint_path=ckpt)
    _assert_same_run(tr, jr, rtol=RTOL)

    # interrupted and resumed: the injected source has no state to save, so
    # the caller positions the replay at the checkpoint
    os.remove(ckpt)
    with pytest.raises(Preempted):
        run_sapg(tp, noise=replay(draws), checkpoint_every=EVERY, checkpoint_path=ckpt,
                 fault_hook=_preempt_before(3))
    done = int(tck.load_checkpoint_arrays(ckpt)["done_iters"])
    assert "generator_state" not in tck.load_checkpoint_arrays(ckpt)
    resumed = run_sapg(tp, noise=replay(draws[n_warm + done:]), checkpoint_every=EVERY,
                       checkpoint_path=ckpt)
    _assert_same_run(resumed, jr, rtol=RTOL)


def test_nan_guard_restores_and_matches_the_clean_run(tmp_path):
    problem = _problem(_cfg())
    clean = run_sapg(problem, torch.Generator().manual_seed(2))
    fired = []
    recovered = run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=EVERY,
                         checkpoint_path=str(tmp_path / "guard.npz"),
                         fault_hook=_nan_once(2, fired))
    assert fired == [2]
    _assert_same_run(recovered, clean)
    assert np.all(np.isfinite(recovered.logPiTrace))


def test_nan_guard_raises_without_a_checkpoint_or_restores():
    problem = _problem(_cfg())

    def corrupt(seg_idx, carry):
        return (torch.full_like(carry[0], float("nan")),) + tuple(carry[1:])

    with pytest.raises(SAPGDivergenceError, match="restores exhausted"):
        run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=EVERY,
                 checkpoint_path=None, fault_hook=corrupt)


def test_nan_guard_raises_once_the_restores_are_used_up(tmp_path):
    problem = _problem(_cfg())

    def corrupt_from_2(seg_idx, carry):
        if seg_idx < 2:
            return carry
        return (torch.full_like(carry[0], float("nan")),) + tuple(carry[1:])

    with pytest.raises(SAPGDivergenceError, match=r"restores exhausted \(1/1\)"):
        run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=EVERY,
                 checkpoint_path=str(tmp_path / "c.npz"), fault_hook=corrupt_from_2,
                 max_restores=1)


def test_orbax_backend_raises(tmp_path):
    problem = _problem(_cfg(samples=10, warmup=2))
    with pytest.raises(NotImplementedError):
        run_sapg(problem, torch.Generator().manual_seed(2), checkpoint_every=4,
                 checkpoint_path=str(tmp_path / "orbax"), checkpoint_backend="orbax")
    with pytest.raises(NotImplementedError):
        tck.save_checkpoint_arrays(str(tmp_path / "o"), {"a": np.zeros(2)}, backend="orbax")
    os.makedirs(tmp_path / "dir")
    with pytest.raises(NotImplementedError):
        tck.load_checkpoint_arrays(str(tmp_path / "dir"))   # a directory is Orbax's layout
    with pytest.raises(ValueError):
        tck.save_checkpoint_arrays(str(tmp_path / "o"), {}, backend="zarr")


def test_checkpoint_arrays_round_trip_and_delete(tmp_path):
    path = str(tmp_path / "c.npz")
    arrays = {"X": np.arange(6.0).reshape(2, 3), "n": np.asarray(3), "s": np.zeros(0)}
    tck.save_checkpoint_arrays(path, arrays)
    back = tck.load_checkpoint_arrays(path)
    assert sorted(back) == sorted(arrays) and not os.path.exists(path + ".tmp.npz")
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    tck.delete_checkpoint(path)
    assert not os.path.exists(path)
    tck.delete_checkpoint(path)   # a missing checkpoint is not an error


def _port_results(moments):
    from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv

    problem = _problem(_cfg(samples=12, warmup=3, track_posterior_moments=moments))
    sapg = run_sapg(problem, torch.Generator().manual_seed(2))
    salsa = salsa_tv(problem.y, problem.H_true, tau=0.05, mu=0.005, blur=problem.blur,
                     max_iter=5)
    return sapg, salsa


def test_save_and_load_results_match_jax(tmp_path):
    sapg, salsa = _port_results(moments=True)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_results(tpath, sapg, salsa)
    jck.save_results(jpath, sapg, salsa)
    for loader in (tck.load_results, jck.load_results):
        t, j = loader(tpath), loader(jpath)
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    t = tck.load_results(tpath)
    np.testing.assert_array_equal(t["sapg/posterior_mean"], sapg.posterior_mean)
    np.testing.assert_array_equal(t["sapg/psf_param_traces/w1"], sapg.psf_param_traces["w1"])
    assert json.loads(str(t["salsa/op_counts"])) == salsa.op_counts
    assert float(t["sapg/scalar/theta_EB"]) == sapg.theta_EB


def test_save_results_without_moments_leaves_the_none_fields_out(tmp_path):
    """The JAX package writes a None field as a pickled object array, which
    its own load_results (allow_pickle=False) cannot read; the port leaves
    such a field out, and the file loads."""
    sapg, salsa = _port_results(moments=False)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_results(tpath, sapg, salsa)
    jck.save_results(jpath, sapg, salsa)
    with pytest.raises(ValueError):
        jck.load_results(jpath)
    t = tck.load_results(tpath)
    with np.load(jpath, allow_pickle=True) as z:
        j = {k: z[k] for k in z.files}
    assert sorted(j) == sorted(list(t) + ["sapg/scalar/posterior_mean",
                                          "sapg/scalar/posterior_var"])
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_run_stats_matches_jax(tmp_path):
    rows = [dict(mse_db=26.5, sapg_time_s=3.0, ssim=0.8), dict(mse_db=24.0, sapg_time_s=5.5),
            dict(mse_db=30.25, ssim=0.9), dict(other=1.0)]
    for i, r in enumerate(rows):
        if i % 2:
            (tmp_path / f"run{i}_results.json").write_text(json.dumps(r))
        else:
            os.makedirs(tmp_path / f"run{i}")
            (tmp_path / f"run{i}" / "results.json").write_text(json.dumps(r))
    (tmp_path / "notes.txt").write_text("not a result")
    t, j = tck.run_stats(str(tmp_path)), jck.run_stats(str(tmp_path))
    assert t == j and t["count"] == 3.0
    assert tck.run_stats(str(tmp_path / "run0")) == jck.run_stats(str(tmp_path / "run0"))
