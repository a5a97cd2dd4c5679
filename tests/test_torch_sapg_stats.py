"""The SAPG step's residual, Parseval statistics and SA updates
(ops/sapg_stats.py), on the CPU.

* Each plain version is bit for bit the step's expressions it took the
  place of (copied below as `_todays_*`): the residual with one H or one a
  problem, the statistics at D ∈ {1, 3} with 0 or 2 free PSF parameters
  and logπ alone (the warm step's), and the SA updates in every branch of
  the config (θ, σ² and PSF log scales, σ² pinned, pinned PSF parameters).
* The wrappers on CPU tensors are the plain versions in the kernels' forms:
  sapg_stats stacks the statistics in `packed`'s row order, sapg_update
  reads such a block (divided by the chains group's size) as the kernel
  does.
* The step on the CPU takes the plain versions, on the resolved route and
  on a forced route 'B'; the wrappers are never called.
* On two gloo ranks, each rank's `packed` all-reduced and read by
  sapg_update gives bit for bit the parent's path (the statistics stacked,
  all-reduced, divided and unbound, then the plain update), the same on
  both ranks.
* The wrappers' launches, on a fake library that checks every argument
  against the entry's ctypes signature, count `launches.sapg_residual`,
  `.sapg_stats` and `.sapg_update`; inside a capture they leave the
  counters as they were and each replay adds them.

The kernels themselves are held against the plain versions on the card
(tests/test_torch_on_card.py).
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from semiblind_tv_tpu_torch import _build
from semiblind_tv_tpu_torch.ops import sapg_stats as ss
from semiblind_tv_tpu_torch.ops.fourier import rfft_weights
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime import profiling
from semiblind_tv_tpu_torch.runtime.distributed import spawn
from semiblind_tv_tpu_torch.runtime.problem import build_problem
from semiblind_tv_tpu_torch.sapg import estimator as est
from semiblind_tv_tpu_torch.utils.images import synthetic_wheel

M, N = 12, 10
NH = N // 2 + 1


def _complex(g, shape, dtype):
    real = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.complex(torch.randn(shape, generator=g, dtype=real),
                         torch.randn(shape, generator=g, dtype=real))


def _inputs(D, C, P, dtype=torch.float32, seed=0, shared_h=None):
    """Random step inputs of D problems × C chains and P free parameters."""
    g = torch.Generator().manual_seed(seed)
    shared_h = P == 0 if shared_h is None else shared_h
    return dict(
        xhat=_complex(g, (D, C, M, NH), dtype),
        h=_complex(g, (M, NH) if shared_h else (D, M, NH), dtype),
        yhat=_complex(g, (D, M, NH), dtype),
        tv=torch.rand((D, C), generator=g, dtype=dtype) * 1e3 + 10.0,
        theta=torch.rand((D,), generator=g, dtype=dtype) * 0.05 + 0.005,
        sigma2=torch.rand((D,), generator=g, dtype=dtype) * 5.0 + 1.0,
        dhs={n: _complex(g, (D, M, NH), dtype) for n in ("alpha", "beta")[:P]},
        weights=rfft_weights((M, N), dtype=dtype),
        dim=M * N,
    )


# ---------------------------------------------------------------------------
# the step's expressions before the kernels (sapg/estimator.py)
# ---------------------------------------------------------------------------

def _todays_residual(H, Xhat, yhat, all_fixed):
    Hl = H[None] if all_fixed else H[:, None]
    Rhat = Hl * Xhat - yhat[:, None]
    return torch.conj(Hl) * Rhat


def _todays_warm_residual(H0, Xhat, yhat):
    Rhat = H0[None] * Xhat - yhat[:, None]
    return torch.conj(H0)[None] * Rhat


def _todays_means(problems, fn, *args):
    means = [{k: torch.mean(v) for k, v in fn(*(a[i] for a in args)).items()}
             for i in range(problems)]
    return {k: means[0][k][None] if problems == 1 else torch.stack([m[k] for m in means])
            for k in means[0]}


def _parseval(w, d):
    def pnorm2(Rhat):
        re, im = Rhat.real, Rhat.imag
        return torch.sum(w[None] * (re * re + im * im), dim=(-2, -1)) / d

    def pdot(Ahat, Bhat):
        return torch.sum(w[None] * (Ahat * torch.conj(Bhat)).real, dim=(-2, -1)) / d

    return pnorm2, pdot


def _todays_stats(xhat, h, yhat, tv, theta, sigma2, dhs, weights, dim):
    D = yhat.shape[0]
    d = dim
    free_names = tuple(dhs)
    pnorm2, pdot = _parseval(weights, d)

    def chain_stats(H, Xhn, yhat, tv, theta, sigma2, *dH):
        Rn = H[None] * Xhn - yhat[None]
        res2 = pnorm2(Rn)
        return dict(
            G_t=d / theta - tv,
            G_s=res2 / (2.0 * sigma2 ** 2) - d / (2.0 * sigma2),
            **{f"G_{n}": pdot(dh[None] * Xhn, Rn) / sigma2 for n, dh in zip(free_names, dH)},
            logPi=-res2 / (2.0 * sigma2) - theta * tv,
            gX=tv,
        )

    Hp = h.expand(D, *h.shape) if h.ndim == 2 else h
    return _todays_means(D, chain_stats, Hp, xhat, yhat, tv, theta, sigma2,
                         *(dhs[n] for n in free_names))


def _todays_logpi(H0, xhat, yhat, tv, sigma0, theta0, weights, dim):
    pnorm2, _ = _parseval(weights, dim)

    def chain_stats(Xh, yhat, tv, sigma0):
        res2 = pnorm2(H0[None] * Xh - yhat[None])
        return dict(logPi=-res2 / (2.0 * sigma0) - theta0 * tv)

    return _todays_means(yhat.shape[0], chain_stats, xhat, yhat, tv, sigma0)["logPi"]


def _todays_update(cfg, sigma_fix, stats, coef, theta, sigma2, params, consts):
    """The trace dict of the SA updates as the step formed it."""
    sapg = cfg.sapg
    dtype, device = theta.dtype, theta.device
    problems = theta.shape[0]
    theta_spec, psf_specs = cfg.theta, cfg.psf_params
    psf_names = tuple(s.name for s in psf_specs)
    free_names = tuple(s.name for s in psf_specs if not s.fix)
    coef_row = {n: 2 + j for j, n in enumerate(free_names)}

    def as_t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    fixed_vals = {s.name: s.clip(as_t(s.true_value)) for s in psf_specs if s.fix}
    log_box = {s.name: (torch.log(as_t(s.box[0])), torch.log(as_t(s.box[1])))
               for s in psf_specs}
    log_theta_box = (torch.log(as_t(theta_spec.box[0])), torch.log(as_t(theta_spec.box[1])))
    zero = torch.zeros((), dtype=dtype, device=device)

    G_t, G_s = stats["G_t"], stats["G_s"]
    G_p = {n: stats[f"G_{n}"] for n in free_names}
    if sapg.theta_log_scale:
        eta_n = torch.clamp(torch.log(theta) + coef[0] * G_t * theta, *log_theta_box)
        theta_n = torch.exp(eta_n)
    else:
        theta_n = theta_spec.clip(theta + coef[0] * G_t)
    params_n = {}
    for s in psf_specs:
        if s.fix:
            params_n[s.name] = fixed_vals[s.name].expand(problems)
        elif sapg.psf_log_scale:
            p = params[s.name]
            lp_n = torch.clamp(torch.log(p) + coef[coef_row[s.name]] * G_p[s.name] * p,
                               *log_box[s.name])
            params_n[s.name] = torch.exp(lp_n)
        else:
            params_n[s.name] = s.clip(params[s.name] + coef[coef_row[s.name]] * G_p[s.name])
    if sigma_fix:
        sigma_n = consts["sigma2_init"]
    elif sapg.sigma_log_scale:
        lsig_n = torch.clamp(
            torch.log(sigma2) + coef[1] * G_s * sigma2,
            torch.log(consts["sigma2_lo"]), torch.log(consts["sigma2_hi"]),
        )
        sigma_n = torch.exp(lsig_n)
    else:
        sigma_n = torch.clamp(sigma2 + coef[1] * G_s, consts["sigma2_lo"], consts["sigma2_hi"])
    return dict(
        theta=theta_n,
        sigma2=sigma_n,
        logPi=stats["logPi"],
        gX=stats["gX"],
        G_t=G_t,
        G_s=G_s,
        **{f"G_{n}": G_p.get(n, zero.expand(problems)) for n in psf_names},
        **{n: params_n[n] for n in psf_names},
    )


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), (a, b)


# ---------------------------------------------------------------------------
# the plain versions against the step's expressions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shared_h", [True, False], ids=["one H", "H a problem"])
@pytest.mark.parametrize("D", [1, 3])
def test_plain_residual_is_the_steps_expression(D, shared_h, dtype):
    a = _inputs(D, 2, 0, dtype, shared_h=shared_h)
    got = ss.sapg_residual_plain(a["xhat"], a["h"], a["yhat"])
    _equal(got, _todays_residual(a["h"], a["xhat"], a["yhat"], shared_h))
    if shared_h:
        _equal(got, _todays_warm_residual(a["h"], a["xhat"], a["yhat"]))
    # the wrapper on CPU tensors
    _equal(ss.sapg_residual(a["xhat"], a["h"], a["yhat"]), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [0, 2])
@pytest.mark.parametrize("D", [1, 3])
def test_plain_statistics_are_the_steps_expressions(D, P, dtype):
    a = _inputs(D, 3, P, dtype, seed=D + P)
    args = (a["xhat"], a["h"], a["yhat"], a["tv"], a["theta"], a["sigma2"], a["dhs"],
            a["weights"], a["dim"])
    got = ss.sapg_stats_plain(*args)
    want = _todays_stats(*args)
    assert list(got) == list(want) == list(ss.stat_names(tuple(a["dhs"])))
    for k in want:
        _equal(got[k], want[k])
    # the wrapper's packed form: the same values stacked in stat_names order
    _equal(ss.sapg_stats(*args), torch.stack(list(want.values())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [1, 3])
def test_plain_logpi_is_the_warm_steps_expression(D, dtype):
    a = _inputs(D, 2, 0, dtype, seed=7)
    theta0 = torch.tensor(0.01, dtype=dtype)
    args = (a["xhat"], a["h"], a["yhat"], a["tv"], theta0.expand(D), a["sigma2"], {},
            a["weights"], a["dim"])
    got = ss.sapg_stats_plain(*args, logpi_only=True)
    assert list(got) == ["logPi"]
    want = _todays_logpi(a["h"], a["xhat"], a["yhat"], a["tv"], a["sigma2"], theta0,
                         a["weights"], a["dim"])
    _equal(got["logPi"], want)
    _equal(ss.sapg_stats(*args, logpi_only=True), want[None])


@pytest.mark.parametrize("D,P,logpi_only", [(1, 0, False), (3, 0, False), (1, 2, False),
                                             (3, 2, False), (1, 0, True), (3, 0, True)])
def test_stat_scales_bound_the_float32_rounding(D, P, logpi_only):
    """stat_scales, the measure the kernel's sums are held to on the card:
    each statistic's magnitude is at most its scale, and the float32 plain
    statistics lie within 1e-5 of it from the float64 ones of the same
    inputs, where G_σ's and G_p's float32 values may be off by far more
    than 1e-5 of themselves."""
    a = _inputs(D, 3, P, torch.float32, seed=20 + D + P)
    args32 = (a["xhat"], a["h"], a["yhat"], a["tv"], a["theta"], a["sigma2"], a["dhs"],
              a["weights"], a["dim"])
    args64 = tuple({k: v.to(torch.complex128) for k, v in x.items()} if isinstance(x, dict)
                   else x.to(torch.complex128) if torch.is_tensor(x) and x.is_complex()
                   else x.double() if torch.is_tensor(x) else x for x in args32)
    scale = ss.stat_scales(*args32, logpi_only=logpi_only)
    exact = torch.stack(list(ss.sapg_stats_plain(*args64, logpi_only=logpi_only).values()))
    f32 = torch.stack(list(ss.sapg_stats_plain(*args32, logpi_only=logpi_only).values()))
    assert scale.dtype == torch.float64 and scale.shape == exact.shape
    assert bool((exact.abs() <= scale * (1 + 1e-12)).all())
    assert float(((f32.double() - exact).abs() / scale).max()) <= 1e-5


LOGS = {"linear": {}, "theta": dict(theta_log_scale=True), "sigma": dict(sigma_log_scale=True),
        "psf": dict(psf_log_scale=True),
        "all": dict(theta_log_scale=True, sigma_log_scale=True, psf_log_scale=True)}


def _update_case(name, logs, D, dtype, seed=0):
    cfg = tcfg.preset(name)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, samples=50,
                                                            **LOGS[logs]))
    free = tuple(s.name for s in cfg.psf_params if not s.fix)
    g = torch.Generator().manual_seed(seed)

    def r(lo, hi):
        return torch.rand((D,), generator=g, dtype=dtype) * (hi - lo) + lo

    # statistics large enough that some updates leave their box
    stats = {k: r(-1e5, 1e5) for k in ss.stat_names(free)}
    lo = r(0.5, 1.0)
    consts = dict(sigma2_lo=lo, sigma2_hi=lo + r(5.0, 50.0), sigma2_init=r(1.0, 5.0))
    params = {s.name: r(*s.box) if not s.fix else
              s.clip(torch.tensor(s.true_value, dtype=dtype)).expand(D)
              for s in cfg.psf_params}
    table = torch.from_numpy(est.sa_step_coefficients(cfg, M * N)).to(dtype)
    return cfg, stats, table, r(*cfg.theta.box), r(1.0, 20.0), params, consts


@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("sigma_fix", [False, True], ids=["sigma free", "sigma pinned"])
@pytest.mark.parametrize("logs", list(LOGS))
@pytest.mark.parametrize("name", ["gaussian", "moffat"], ids=["psf pinned", "psf free"])
def test_plain_update_is_the_steps_expressions(name, logs, sigma_fix, D):
    dtype = torch.float32
    cfg, stats, table, theta, sigma2, params, consts = _update_case(name, logs, D, dtype)
    rule = ss.sa_rule(cfg, sigma_fix, dtype, "cpu")
    assert rule.free_names == (() if name == "gaussian" else ("alpha", "beta"))
    for ii in (2, 9, 50):
        coef = ss.coefficient_column(table, ii)
        rows = ss.sapg_update_plain(stats, coef, theta, sigma2, params, consts, rule)
        want = _todays_update(cfg, sigma_fix, stats, coef, theta, sigma2, params, consts)
        assert tuple(want) == ss.trace_names(rule.psf_names)
        _equal(rows, torch.stack(list(want.values())))
        # the wrapper reads the packed statistics as the kernel does: summed
        # over one rank, or over two and divided by two
        packed = torch.stack([stats[k] for k in ss.stat_names(rule.free_names)])
        _equal(ss.sapg_update(packed, 1, table, ii, theta, sigma2, params, consts, rule), rows)
        summed = packed * 2
        halves = dict(zip(stats, (summed / 2).unbind(0)))
        _equal(ss.sapg_update(summed, 2, table, torch.tensor([ii]), theta, sigma2, params,
                              consts, rule),
               ss.sapg_update_plain(halves, coef, theta, sigma2, params, consts, rule))


def test_the_update_rules_kernel_form():
    """sa_rule's flags, pinned mask and the kernel's box block."""
    cfg = tcfg.preset("moffat")
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, theta_log_scale=True,
                                                            psf_log_scale=True))
    rule = ss.sa_rule(cfg, True, torch.float64, "cpu")
    assert rule.flags == 1 | 4 | 8 and rule.pinned == 0
    assert rule.box.dtype == torch.float32 and rule.box.shape == (4 + 5 * 2,)
    assert rule.box[:2].tolist() == np.float32(cfg.theta.box).tolist()
    g = tcfg.preset("gaussian")
    grule = ss.sa_rule(g, False, torch.float32, "cpu")
    assert grule.flags == 0 and grule.pinned == 0b11
    assert grule.box[4 + 4].item() == np.float32(g.psf_params[0].true_value)


# ---------------------------------------------------------------------------
# the step's dispatch on the CPU
# ---------------------------------------------------------------------------

def _small_problem(name):
    cfg = tcfg.preset(name)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, samples=6, warmup=4,
                                                            burn_in=4))
    x = synthetic_wheel(32)
    obs = np.random.default_rng(0).standard_normal(x.shape)
    return build_problem(x, cfg, dtype=torch.float32, device="cpu", noise=obs)


@pytest.mark.parametrize("route", [None, "B"], ids=["resolved", "forced B"])
@pytest.mark.parametrize("name", ["gaussian", "moffat"])
def test_the_step_on_the_cpu_takes_the_plain_versions(name, route, monkeypatch):
    problem = _small_problem(name)
    calls = {"residual": 0, "stats": 0, "update": 0}

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on the CPU")

    for fn in ("sapg_residual", "sapg_stats", "sapg_update"):
        monkeypatch.setattr(est, fn, refuse)
    for key, fn in (("residual", "sapg_residual_plain"), ("stats", "sapg_stats_plain"),
                    ("update", "sapg_update_plain")):
        real = getattr(est, fn)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(est, fn, spy)
    g = torch.Generator().manual_seed(1)
    res = est.run_sapg(problem, noise=lambda shape: torch.randn(shape, generator=g),
                       n_chains=2, route=route)
    warm, main = 3, 5
    assert calls == {"residual": warm + main, "stats": warm + 1 + main, "update": main}
    assert np.all(np.isfinite(res.thetas))


# ---------------------------------------------------------------------------
# packed across two gloo ranks
# ---------------------------------------------------------------------------

def _gloo_rank(rank, P, D):
    """Rank `rank` of two: its half of the chains' statistics, summed over
    the group, then the update; the kernels' path (packed, then sapg_update
    reading it) and the parent's (the dict stacked, all-reduced, divided and
    unbound, then the plain update)."""
    torch.set_num_threads(1)
    a = _inputs(D, 4, P, seed=11 + P)
    half = slice(2 * rank, 2 * rank + 2)
    args = (a["xhat"][:, half].contiguous(), a["h"], a["yhat"], a["tv"][:, half].contiguous(),
            a["theta"], a["sigma2"], a["dhs"], a["weights"], a["dim"])
    cfg = tcfg.preset("moffat" if P else "gaussian")
    rule = ss.sa_rule(cfg, False, torch.float32, "cpu")
    table = torch.from_numpy(est.sa_step_coefficients(cfg, M * N)).to(torch.float32)
    consts = dict(sigma2_lo=torch.full((D,), 0.5), sigma2_hi=torch.full((D,), 40.0),
                  sigma2_init=torch.full((D,), 2.0))
    params = {s.name: torch.full((D,), sum(s.box) / 2) if not s.fix else
              s.clip(torch.tensor(s.true_value)).expand(D) for s in cfg.psf_params}
    common = (table, 7, a["theta"], a["sigma2"], params, consts, rule)

    packed = ss.sapg_stats(*args)
    dist.all_reduce(packed)
    kernels = ss.sapg_update(packed, 2, *common)

    stats = _todays_stats(*args)
    summed = torch.stack(list(stats.values()))
    dist.all_reduce(summed)
    stats = dict(zip(stats, (summed / 2).unbind(0)))
    parent = torch.stack(list(_todays_update(cfg, False, stats,
                                             ss.coefficient_column(table, 7), a["theta"],
                                             a["sigma2"], params, consts).values()))
    return kernels.numpy(), parent.numpy()


@pytest.mark.parametrize("P,D", [(0, 1), (2, 3)])
def test_packed_statistics_on_two_gloo_ranks(P, D):
    out = spawn(_gloo_rank, 2, (P, D), timeout=120)
    for kernels, parent in out:
        assert np.array_equal(kernels, parent)
    assert np.array_equal(out[0][0], out[1][0])
    assert kernels.shape == (len(ss.trace_names(("alpha", "beta") if P else ("w1", "w2"))), D)


# ---------------------------------------------------------------------------
# the launch counters
# ---------------------------------------------------------------------------

class _FakeLibrary:
    """The kernel library's entries as stubs that check each argument
    against the entry's ctypes signature and launch nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        argtypes, _ = _build._SIGNATURES[name]

        def entry(*args):
            assert len(args) == len(argtypes), (name, len(args), len(argtypes))
            for t, v in zip(argtypes, args):
                t.from_param(v)
            self.calls.append(name)
            return 1024 if name == "sb_sapg_stats_span" else 0

        return entry


def test_the_launch_counters_under_a_captured_and_replayed_fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(ss, "_device_kind", lambda x, what: "cuda")
    monkeypatch.setattr(ss, "_stream", lambda device: 0)
    a = _inputs(2, 3, 2, shared_h=False)
    cfg = tcfg.preset("moffat")
    rule = ss.sa_rule(cfg, False, torch.float32, "cpu")
    table = torch.from_numpy(est.sa_step_coefficients(cfg, M * N)).to(torch.float32)
    consts = dict(sigma2_lo=torch.ones(2), sigma2_hi=torch.ones(2) * 9, sigma2_init=torch.ones(2))
    params = {"alpha": torch.ones(2), "beta": torch.ones(2)}
    names = ("launches.sapg_residual", "launches.sapg_stats", "launches.sapg_update")
    workspace = {}
    c = profiling.counters
    profiling.reset()
    try:
        with profiling.capturing() as cap:
            ghat = ss.sapg_residual(a["xhat"], a["h"], a["yhat"])
            packed = ss.sapg_stats(a["xhat"], a["h"], a["yhat"], a["tv"], a["theta"],
                                   a["sigma2"], a["dhs"], a["weights"], a["dim"],
                                   workspace=workspace)
            warm = ss.sapg_stats(a["xhat"], a["h"][0], a["yhat"], a["tv"],
                                 torch.tensor(0.01).expand(2), a["sigma2"], {}, a["weights"],
                                 a["dim"], logpi_only=True, workspace=workspace)
            rows = ss.sapg_update(packed, 4, table, torch.tensor([3]), a["theta"], a["sigma2"],
                                  params, consts, rule)
        assert ghat.shape == a["xhat"].shape and packed.shape == (6, 2) and warm.shape == (1, 2)
        assert rows.shape == (10, 2)
        assert [c[n] for n in names] == [0, 0, 0]
        assert cap.launches == {"launches.sapg_residual": 1, "launches.sapg_stats": 2,
                                "launches.sapg_update": 1}
        for _ in range(3):
            profiling.replayed(cap)
        assert [c[n] for n in names] == [3, 6, 3]
        assert lib.calls.count("sb_sapg_stats") == 2 and lib.calls.count("sb_sapg_update") == 1
        # the caller's workspace: one set of buffers for both statistics
        # launches of the same shape, sized for the most free parameters
        assert list(workspace) == [(6, M * NH)]
        partials, chain_stats, ticket = workspace[(6, M * NH)]
        assert partials.numel() == (1 + ss.MAX_PSF) * 6
        assert chain_stats.numel() == (4 + ss.MAX_PSF) * 6
        assert torch.equal(ticket, torch.zeros(7, dtype=torch.int32))
    finally:
        profiling.reset()
