"""Port vs JAX package: the sharded SAPG (parallel/sapg_parallel.py).

The JAX side runs here, on the 8-device virtual CPU mesh of conftest.py.
The port's side runs in gloo worlds of 1, 2 and 4 processes on the CPU
(runtime/distributed.spawn: torch.multiprocessing, a FileStore in a
temporary directory, a 60 s timeout on every group, one thread a process),
spawned once per world size for the module; the workers import neither
jax nor this module's JAX side (the JAX imports live in the fixture) and
pass their numbers back as pickles.  float64 throughout.

* the port's run_sapg(mesh=) fed the JAX draws against JAX
  run_sapg_sharded: traces and EB at 1e-10, X_last and the posterior
  moments as tests/test_parallel.py holds the JAX package to its own
  single-device run;
* layout invariance: 4 chains as 1×4, 2×2 and 4×1 (ranks × chains a rank)
  against the port's single-device run at 1e-9;
* the data axis: two problems batched on one rank, and split over a
  (2, 1) mesh, against two single-problem runs at 1e-12;
* checkpoint/resume (npz, and the directory backend across 2 processes)
  equal to the uninterrupted run; the NaN guard restores, and raises
  without a checkpoint;
* per-chain scalars: the kernels' CPU emulations (A1, A2, B, C's plain
  version, the blocked schedule) with one value a chain equal chain-by-chain
  calls with 0-d scalars.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime.distributed import spawn
from semiblind_tv_tpu_torch.utils.images import synthetic_wheel

SIZE = 32
C = 4
EXACT = 1e-12


class Preempted(Exception):
    pass


def _short(cfg, samples=24, warmup=6, burn_in=16, **kw):
    return dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=samples, warmup=warmup, burn_in=burn_in, **kw))


def _cfg(**kw):
    return _short(tcfg.gaussian_preset(fix_w1=False, fix_w2=False), **kw)


def _problem(seed, cfg=None):
    from semiblind_tv_tpu_torch.runtime.problem import build_problem

    return build_problem(synthetic_wheel(SIZE), cfg or _cfg(), torch.Generator().manual_seed(seed),
                         dtype=torch.float64, device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bundle(r):
    out = dict(thetas=r.thetas, sigma2s=r.sigma2s, logPiTrace=r.logPiTrace,
               logPiTrace_warmup=r.logPiTrace_warmup, gX=r.gX, X_last=r.X_last,
               theta_EB=r.theta_EB, sigma2_EB=r.sigma2_EB, psf_params_EB=r.psf_params_EB,
               psf=r.psf_param_traces)
    if r.posterior_mean is not None:
        out.update(posterior_mean=r.posterior_mean, posterior_var=r.posterior_var)
    return out


def _preempt_before(seg):
    def hook(seg_idx, carry):
        if seg_idx == seg:
            raise Preempted()
        return carry
    return hook


# ---------------------------------------------------------------------------
# The port's side, in each world
# ---------------------------------------------------------------------------

def _world(rank, case_dir):
    from semiblind_tv_tpu_torch.cli.run_demo import main as run_demo_main
    from semiblind_tv_tpu_torch.cli.run_sharded import main as run_sharded_main
    from semiblind_tv_tpu_torch.parallel.mesh import make_mesh
    from semiblind_tv_tpu_torch.parallel.sapg_parallel import run_sapg_sharded
    from semiblind_tv_tpu_torch.runtime.distributed import local_slice_info, world_size
    from semiblind_tv_tpu_torch.runtime.problem import problem_from_arrays
    from semiblind_tv_tpu_torch.sapg.estimator import SAPGDivergenceError, run_sapg

    S = world_size()
    out = {}
    mesh = make_mesh(1, S, device_type="cpu")
    out["layout"] = run_sapg(_problem(1), _gen(5), n_chains=C, mesh=mesh).thetas
    pa, pb = _problem(1), _problem(2)
    if S == 1:
        out["single"] = run_sapg(pa, _gen(5), n_chains=C).thetas
        # the data axis batched: two problems, one launch a step on one rank
        batched = run_sapg_sharded([pa, pb], mesh, [_gen(7), _gen(8)], chains_per_shard=C)
        out["data"] = [_bundle(r) for r in batched]
        out["data_ref"] = [_bundle(run_sapg(p, _gen(s), n_chains=C))
                           for p, s in ((pa, 7), (pb, 8))]
        # checkpoint/resume and the NaN guard (npz)
        ck = os.path.join(case_dir, "s1.npz")
        full = run_sapg(pa, _gen(9), n_chains=C, mesh=mesh)
        try:
            run_sapg(pa, _gen(9), n_chains=C, mesh=mesh, checkpoint_every=7, checkpoint_path=ck,
                     fault_hook=_preempt_before(2))
        except Preempted:
            pass
        resumed = run_sapg(pa, _gen(70), n_chains=C, mesh=mesh, checkpoint_every=7,
                           checkpoint_path=ck)
        out["resume"] = (_bundle(resumed), _bundle(full))
        fired = []

        def nan_once(seg_idx, carry):
            if seg_idx == 2 and not fired:
                fired.append(seg_idx)
                X = carry[0].clone()
                X[0, 0, 0] = float("nan")
                return (X,) + tuple(carry[1:])
            return carry

        guarded = run_sapg(pa, _gen(9), n_chains=C, mesh=mesh, checkpoint_every=7,
                           checkpoint_path=os.path.join(case_dir, "guard.npz"),
                           fault_hook=nan_once)
        out["nan_guard"] = (_bundle(guarded), _bundle(full), list(fired))
        try:
            run_sapg(pa, _gen(9), n_chains=C, mesh=mesh, checkpoint_every=7,
                     fault_hook=lambda i, c: (torch.full_like(c[0], float("nan")),) + c[1:])
            out["nan_raises"] = False
        except SAPGDivergenceError:
            out["nan_raises"] = True
    cli = ["--device", "cpu", "--image", "synthetic", "--size", "32", "--no-fix-w",
           "--samples", "10", "--warmup", "4"]
    if S == 1:
        # one problem: run_sharded draws as run_demo does with the same seed
        out["cli_demo"] = run_demo_main(cli + ["--chains", "2"])["theta_EB"]
        out["cli_sharded"] = run_sharded_main(cli + ["--chains-per-shard", "2", "--no-map"])
        out["cli_bare"] = run_sharded_main(cli + ["--problems", "2", "--bare", "--steps", "5"])
    if S == 2:
        out["slice_info"] = local_slice_info()
        out["cli_data"] = run_sharded_main(cli + ["--data", "2"])
        # the JAX draws replayed through the port's sharded run
        z = np.load(os.path.join(case_dir, "jax_inputs.npz"))
        arrays = {k: z[k] for k in z.files if not k.startswith(("draw", "box"))}
        arrays["sigma2_box"] = (z["box_lo"], z["box_hi"])
        jp = problem_from_arrays(_cfg(track_posterior_moments=True), arrays, device="cpu",
                                 dtype=torch.float64)
        draws = iter(z["draws"])
        res = run_sapg(jp, None, n_chains=C, mesh=mesh,
                       noise=lambda shape: torch.from_numpy(next(draws)))
        out["parity"] = _bundle(res)
        # the data axis split over the ranks: a (2, 1) mesh
        mesh21 = make_mesh(2, 1, device_type="cpu")
        split = run_sapg_sharded([pa, pb], mesh21, [_gen(7), _gen(8)], chains_per_shard=C)
        out["data_split"] = [_bundle(r) for r in split]
        # the directory backend, every rank writing its own arrays
        ck = os.path.join(case_dir, "dcp")
        full = run_sapg(pa, _gen(9), n_chains=C, mesh=mesh)
        try:
            run_sapg(pa, _gen(9), n_chains=C, mesh=mesh, checkpoint_every=7, checkpoint_path=ck,
                     checkpoint_backend="orbax", fault_hook=_preempt_before(2))
        except Preempted:
            pass
        saved = sorted(os.listdir(ck)) if rank == 0 else None
        resumed = run_sapg(pa, _gen(70), n_chains=C, mesh=mesh, checkpoint_every=7,
                           checkpoint_path=ck, checkpoint_backend="orbax")
        out["dcp"] = (_bundle(resumed), _bundle(full), saved)
    return out


# ---------------------------------------------------------------------------
# The JAX side and the worlds, once for the module
# ---------------------------------------------------------------------------

def _jax_sharded_draws(key, n_chains, shape, n_steps):
    """The per-chain noise of JAX run_sapg_sharded for one problem and one
    key: keys split (1, C), then estimator.chain_noise each step."""
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(key, (1, n_chains))[0]
    out = []
    for _ in range(n_steps):
        ks = jax.vmap(jax.random.split)(keys)
        keys, subs = ks[:, 0], ks[:, 1]
        out.append(np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float64))(subs)))
    return np.stack(out)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from semiblind_tv_tpu.parallel.mesh import make_mesh as j_make_mesh
    from semiblind_tv_tpu.parallel.sapg_parallel import run_sapg_sharded as j_run_sapg_sharded
    from semiblind_tv_tpu.runtime import build_problem as j_build_problem
    from semiblind_tv_tpu.runtime import config as jcfg
    from tests.test_torch_sapg import jax_problem_arrays

    case_dir = str(tmp_path_factory.mktemp("parallel"))
    jc = _short(jcfg.gaussian_preset(fix_w1=False, fix_w2=False), track_posterior_moments=True)
    jp = j_build_problem(synthetic_wheel(SIZE), jc, jax.random.key(0), dtype=jnp.float64)
    key = jax.random.key(5)
    jmesh = j_make_mesh(data=1, chains=2, devices=jax.devices()[:2])
    [jres] = j_run_sapg_sharded([jp], jmesh, key, chains_per_shard=C // 2)
    arrays = jax_problem_arrays(jp)
    lo, hi = arrays.pop("sigma2_box")
    n_steps = (jc.sapg.warmup - 1) + (jc.sapg.samples - 1)
    np.savez(os.path.join(case_dir, "jax_inputs.npz"), box_lo=lo, box_hi=hi,
             draws=_jax_sharded_draws(key, C, (SIZE, SIZE), n_steps), **arrays)
    ports = {S: spawn(_world, S, (case_dir,), timeout=60) for S in (1, 2, 4)}
    return dict(jax=jres, ports=ports)


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _same_run(a, b, rtol=EXACT):
    for k in ("thetas", "sigma2s", "logPiTrace", "logPiTrace_warmup", "gX"):
        _close(a[k], b[k], rtol)
    for n in b["psf"]:
        _close(a["psf"][n], b["psf"][n], rtol)
    _close(a["X_last"], b["X_last"], rtol, 1e-12)
    assert a["theta_EB"] == pytest.approx(b["theta_EB"], rel=rtol)
    assert a["sigma2_EB"] == pytest.approx(b["sigma2_EB"], rel=rtol)


# ---------------------------------------------------------------------------
# The checks, one a test
# ---------------------------------------------------------------------------

def test_sharded_matches_jax_traces(worlds):
    got, ref = worlds["ports"][2][0]["parity"], worlds["jax"]
    for k in ("thetas", "sigma2s", "logPiTrace", "logPiTrace_warmup", "gX"):
        _close(got[k], getattr(ref, k), 1e-10)
    for n in ref.psf_param_traces:
        _close(got["psf"][n], ref.psf_param_traces[n], 1e-10)


def test_sharded_matches_jax_estimates(worlds):
    got, ref = worlds["ports"][2][0]["parity"], worlds["jax"]
    assert got["theta_EB"] == pytest.approx(ref.theta_EB, rel=1e-10)
    assert got["sigma2_EB"] == pytest.approx(ref.sigma2_EB, rel=1e-10)
    for n, v in ref.psf_params_EB.items():
        assert got["psf_params_EB"][n] == pytest.approx(v, rel=1e-10)


def test_sharded_matches_jax_states_and_moments(worlds):
    got, ref = worlds["ports"][2][0]["parity"], worlds["jax"]
    assert got["X_last"].shape == (C, SIZE, SIZE)
    _close(got["X_last"], ref.X_last, 1e-10, 1e-12)
    _close(got["posterior_mean"], ref.posterior_mean, 1e-10, 1e-12)
    _close(got["posterior_var"], ref.posterior_var, 1e-8, 1e-14)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_layout_invariance(worlds, S):
    """4 chains as S ranks × 4/S chains: the single-device trajectory."""
    _close(worlds["ports"][S][0]["layout"], worlds["ports"][1][0]["single"], 1e-9)


def test_every_rank_returns_the_same_results(worlds):
    ranks = worlds["ports"][2]
    np.testing.assert_array_equal(ranks[0]["layout"], ranks[1]["layout"])
    assert [r["slice_info"] for r in ranks] == [
        dict(process_index=r, process_count=2, local_devices=2, global_devices=2) for r in (0, 1)]
    for a, b in zip(ranks[0]["data_split"], ranks[1]["data_split"]):
        np.testing.assert_array_equal(a["thetas"], b["thetas"])
        np.testing.assert_array_equal(a["X_last"], b["X_last"])


def test_data_axis_batched_on_one_rank(worlds):
    """Two problems in one launch a step equal their single-problem runs."""
    got, ref = worlds["ports"][1][0]["data"], worlds["ports"][1][0]["data_ref"]
    assert not np.allclose(got[0]["thetas"], got[1]["thetas"])
    for a, b in zip(got, ref):
        _same_run(a, b)


def test_data_axis_split_over_ranks(worlds):
    got, ref = worlds["ports"][2][0]["data_split"], worlds["ports"][1][0]["data_ref"]
    assert len(got) == 2
    for a, b in zip(got, ref):
        _same_run(a, b)


def test_mesh_checkpoint_resume(worlds):
    resumed, full = worlds["ports"][1][0]["resume"]
    _same_run(resumed, full)


def test_mesh_nan_guard_restores(worlds):
    guarded, full, fired = worlds["ports"][1][0]["nan_guard"]
    assert fired == [2]
    _same_run(guarded, full)


def test_mesh_nan_guard_raises_without_checkpoint(worlds):
    assert worlds["ports"][1][0]["nan_raises"] is True


def test_directory_checkpoint_two_processes(worlds):
    resumed, full, saved = worlds["ports"][2][0]["dcp"]
    assert ".metadata" in saved
    _same_run(resumed, full)


def test_run_sharded_one_problem_is_run_demo(worlds):
    out = worlds["ports"][1][0]
    [entry] = out["cli_sharded"]["problems"]
    assert out["cli_sharded"]["chains_per_problem"] == 2
    assert entry["theta_EB"] == pytest.approx(out["cli_demo"], rel=EXACT)


def test_run_sharded_bare_stepper(worlds):
    bare = worlds["ports"][1][0]["cli_bare"]
    assert bare["problems"] == 2 and bare["chains_per_problem"] == 1
    assert len(bare["theta_last"]) == 2 and np.all(np.isfinite(bare["theta_last"]))
    assert bare["theta_last"][0] != bare["theta_last"][1]


def test_run_sharded_data_axis_two_processes(worlds):
    a, b = (worlds["ports"][2][r]["cli_data"] for r in (0, 1))
    assert a["mesh"] == {"data": 2, "chains": 1} and len(a["problems"]) == 2
    for pa, pb in zip(a["problems"], b["problems"]):
        assert pa == pb   # every rank returns every problem, MAP included
        assert np.isfinite(pa["theta_EB"]) and pa["mse_db"] < pa["mse_db_observation"]


def test_entry_points_default_to_the_card(tmp_path):
    """The parallel entry points default to cuda; without a card they raise
    instead of running on the CPU (here, before any group is made)."""
    import inspect

    from semiblind_tv_tpu_torch.benchmarks import run_reference_images
    from semiblind_tv_tpu_torch.cli import run_sharded
    from semiblind_tv_tpu_torch.parallel import mesh

    for fn in (mesh.make_mesh, mesh.make_spatial_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        mesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError):
        run_sharded.main(["--size", "16", "--image", "synthetic", "--samples", "4"])
    with pytest.raises(RuntimeError):
        run_reference_images.main(["--images", "synthetic", "--size", "16", "--samples", "4",
                                   "--warmup", "2", "--out", str(tmp_path)])


# ---------------------------------------------------------------------------
# Per-chain scalars: the emulations with (B,) scalars = per-chain 0-d calls
# ---------------------------------------------------------------------------

def _fields(B, M=24, N=40, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((B, M, N)) * 255)
    return x, x + torch.from_numpy(rng.standard_normal((B, M, N))) * 0.1, \
        torch.from_numpy(rng.standard_normal((B, M, N))) * 0.01, \
        torch.from_numpy(rng.standard_normal((B, M, N)))


def _per_chain_equal(call, vec_args, B):
    """call(*args) with (B,) scalars against chain b's call with 0-d ones."""
    whole = call(*vec_args, None)
    for b in range(B):
        one = call(*(v[b] if torch.is_tensor(v) and v.ndim == 1 else v for v in vec_args), b)
        for w, o in zip(whole, one):
            assert torch.equal(w[b], o[0]), b


@pytest.mark.parametrize("form", ["A1", "A2"])
def test_chain_scalars_resident_prox_emulated(form):
    from semiblind_tv_tpu_torch.ops.tv_cuda import chambolle_prox_resident_emulated

    B = 3
    g, p1, p2, _ = _fields(B)
    lam = torch.tensor([0.5, 20.0, 3.0], dtype=torch.float64)

    def call(lam, b):
        sl = slice(None) if b is None else slice(b, b + 1)
        duals = (p1[sl], p2[sl]) if form == "A1" else None
        f, st = chambolle_prox_resident_emulated(g[sl], lam, 10 if form == "A1" else 25,
                                                 tol=1e-3, duals=duals, capacity=8)
        return f, st.px, st.py, st.iters[:, None, None], st.err[:, None, None]

    _per_chain_equal(call, (lam,), B)


@pytest.mark.parametrize("form", ["B", "C"])
def test_chain_scalars_step_emulated(form):
    from semiblind_tv_tpu_torch.ops import fused_step_cuda as fs

    B = 3
    x, prox, grad, z = _fields(B, seed=1)
    gam = torch.tensor([1.9, 1.5, 0.7], dtype=torch.float64)
    lam = torch.tensor([2.0, 1.0, 3.0], dtype=torch.float64)
    lt = torch.tensor([0.02, 0.5, 0.1], dtype=torch.float64)
    seeds = torch.tensor([[1, 2], [3, -4], [5, 6]], dtype=torch.int32)

    def call(gam, lam, lt, b):
        sl = slice(None) if b is None else slice(b, b + 1)
        if form == "B":
            xn, pn, tv, it = fs.myula_prox_tv_emulated(x[sl], prox[sl], grad[sl], z[sl], gam,
                                                       lam, lt, capacity=8)
            return xn, pn, tv[:, None, None], it[:, None, None]
        xn, pn, tv = fs.myula_prox_tv_rng_plain(x[sl], prox[sl], grad[sl], seeds[sl], gam, lam,
                                                lt)
        return xn, pn, tv[:, None, None]

    _per_chain_equal(call, (gam, lam, lt), B)


def test_chain_scalars_blocked_emulated():
    from semiblind_tv_tpu_torch.ops.tv_blocked_cuda import chambolle_prox_blocked_emulated

    B = 2
    g = _fields(B, 40, 70, seed=2)[0]
    lam = torch.tensor([0.5, 6.0], dtype=torch.float64)

    def call(lam, b):
        sl = slice(None) if b is None else slice(b, b + 1)
        f, st = chambolle_prox_blocked_emulated(g[sl], lam, 25, tol=1e-3, geometry=(16, 32, 7))
        return f, st.px, st.iters[:, None, None]

    _per_chain_equal(call, (lam,), B)


def test_chain_scalar_forms():
    """scalar_on: 0-d for a number or one value (stride 0), (B,) for B
    values (stride 1); anything else raises."""
    from semiblind_tv_tpu_torch.ops.tv_cuda import chain_scalars, per_chain, scalar_on

    like = torch.zeros(3, 4, 4, dtype=torch.float32)
    t, s = scalar_on(0.5, like, "lam")
    assert t.shape == () and s == 0
    t, s = scalar_on(torch.tensor([0.5]), like, "lam")
    assert t.shape == () and s == 0
    t, s = scalar_on(torch.ones(3, 1, 1), like, "lam")
    assert t.shape == (3,) and s == 1
    with pytest.raises(ValueError):
        scalar_on(torch.ones(2), like, "lam")
    with pytest.raises(ValueError):
        scalar_on(torch.ones(3, dtype=torch.float64), like, "lam")
    _, strides = chain_scalars(((1.0, "a"), (torch.ones(3), "b"), (torch.ones(()), "c"),
                                (torch.ones(3), "d")), like)
    assert strides == 0b1010
    assert per_chain(torch.ones(3), like).shape == (3, 1, 1)
    assert per_chain(torch.ones(()), like).shape == ()


# ---------------------------------------------------------------------------
# The data axis's chain-count rules: one problem's chains, as JAX's vmap
# ---------------------------------------------------------------------------

def test_data_axis_auto_rules_see_one_problems_chains(monkeypatch):
    """Two problems of two chains batched in one step (route 'B' forced on
    CPU tensors: the kernels' plain versions run) in dft mode at 32² with
    fuse_dft=None and in_kernel_rng=True.  The JAX package vmaps one
    problem's step over the problems, so its rules see 2 chains: kernel D
    runs and no seeds are drawn.  The batched step takes D's wrapper on
    every step, the rank's noise source draws normals, and each problem's
    trajectory equals its own two-chain run on the same noise (EXACT)."""
    from semiblind_tv_tpu_torch.parallel.mesh import RankLayout
    from semiblind_tv_tpu_torch.sapg import estimator as est

    D, Cl, steps = 2, 2, 6
    cfg = _cfg(fft_mode="dft", in_kernel_rng=True)
    problems = [_problem(s, cfg) for s in (11, 12)]
    calls = {"D": 0, "C": 0, "B": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(est, "myula_prox_tv_dft", spy("D", est.myula_prox_tv_dft))
    monkeypatch.setattr(est, "myula_prox_tv_rng", spy("C", est.myula_prox_tv_rng))
    monkeypatch.setattr(est, "myula_prox_tv", spy("B", est.myula_prox_tv))
    run = est.SAPGRun(problems, RankLayout(problems=range(D), rows=slice(0, Cl),
                                           device=torch.device("cpu")), route="B")
    step, aux, consts = run.step, run.aux, run.consts
    assert aux["fuse_dft"](Cl) and not aux["in_kernel_rng"](Cl)

    rng = np.random.default_rng(7)
    draws = rng.standard_normal((D, steps, Cl, SIZE, SIZE))
    its = [iter(draws[d]) for d in range(D)]

    def no_seeds(n):
        raise AssertionError("seeds drawn where JAX draws normals")

    draw, _ = run.draws(
        noise=[lambda shape, d=d: torch.from_numpy(next(its[d])) for d in range(D)],
        seeds=[no_seeds] * D)
    carry = aux["main_carry"](run.start(run.init_x()), consts)
    batched = []
    for ii in range(2, steps + 2):
        carry, tr = step(carry, ii, consts, draw())
        batched.append((carry[0], carry[3], carry[4], tr))
    assert calls == {"D": steps, "C": 0, "B": 0}

    for d, p in enumerate(problems):
        calls.update(D=0, C=0, B=0)
        s_step, s_aux = est.make_sapg_step(p, Cl, route="B")
        assert s_aux["fuse_dft"](Cl) and not s_aux["in_kernel_rng"](Cl)
        X = p.y.expand(Cl, SIZE, SIZE).contiguous()
        c = s_aux["main_carry"](
            (X, p.blur.rfft(X), s_aux["prox_b"](X, s_aux["lam"] * s_aux["theta0"])[0]),
            s_aux["consts"])
        for t, ii in enumerate(range(2, steps + 2)):
            c, tr = s_step(c, ii, torch.from_numpy(draws[d, t]))
            X, theta, sigma2, btr = batched[t]
            np.testing.assert_allclose(X[d * Cl:(d + 1) * Cl].numpy(), c[0].numpy(), rtol=EXACT,
                                       atol=EXACT)
            np.testing.assert_allclose(float(theta[d]), float(c[3]), rtol=EXACT)
            np.testing.assert_allclose(float(sigma2[d]), float(c[4]), rtol=EXACT)
            for k, v in tr.items():
                np.testing.assert_allclose(float(btr[k][d]), float(v), rtol=EXACT, atol=EXACT,
                                           err_msg=k)
        assert calls == {"D": steps, "C": 0, "B": 0}
