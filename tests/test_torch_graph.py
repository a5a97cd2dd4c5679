"""The capture-safe SAPG step and the rule that replays it as CUDA graphs,
on the CPU (sapg/estimator.py: sa_step_coefficients, _Iterations,
resolve_graph_replay; runtime/profiling.py: capturing, replayed).

* The SA updates' coefficient table is, column for column, the float32
  cast of the Python expressions the updates multiplied before
  (step_scale · δ(ii) with δ(ii) = d_scale · ii^(−d_exp) / d).
* A float32 run whose updates multiply the table's entries gives the same
  θ, σ², PSF-parameter and logπ traces and X_last, bit for bit, as the same
  run with those Python floats (today's formulas), for the Gaussian
  (pinned) and Moffat (free) presets with the log-scale options off and on.
* The iterations and their trace store with device indices (what a graph
  captures) equal the same with host ints, bit for bit, for one problem and
  for two problems batched (estimator._Iterations).
* One problem's warm-up and SAPG iterations dispatch the non-view
  operations of the one-card step that held θ and σ² as 0-d tensors, and
  not the copies the problem-batched form made for a batch of one.
* The engagement rule takes the graphs only on a CUDA device, route 'B',
  fft_mode 'fft', a noise field and no posterior moments.
* A capture's launch and sweep reports leave the counters as they were and
  are handed over once a replay; an eager run counts every iteration in
  `graph.eager_steps`.

The CUDA graphs themselves are held against the eager run on the card
(tests/test_torch_on_card.py).
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

from semiblind_tv_tpu_torch.parallel.mesh import RankLayout
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime import profiling
from semiblind_tv_tpu_torch.runtime.problem import build_problem
from semiblind_tv_tpu_torch.sapg import estimator as est
from semiblind_tv_tpu_torch.utils.images import synthetic_wheel

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, logs=False, samples=40, warmup=8):
    cfg = tcfg.preset(name)
    return dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=samples, warmup=warmup, burn_in=(samples * 80) // 100,
        theta_log_scale=logs, sigma_log_scale=logs, psf_log_scale=logs))


def _problem(cfg):
    x = synthetic_wheel(SIZE)
    obs = np.random.default_rng(0).standard_normal(x.shape)
    return build_problem(x, cfg, dtype=torch.float32, device="cpu", noise=obs)


def _today(cfg, dim, ii):
    """The coefficients as the updates' Python expressions formed them."""
    sapg = cfg.sapg
    d_scale = sapg.d_scale if sapg.d_scale is not None else 0.01 / cfg.theta.init
    delta_i = d_scale * float(ii) ** (-sapg.d_exp) / dim
    return [cfg.theta.step_scale * delta_i, cfg.sigma_step_scale * delta_i] + [
        s.sign * s.step_scale * delta_i for s in cfg.psf_params if not s.fix]


@pytest.mark.parametrize("name", ["gaussian", "moffat", "laplace"])
def test_coefficient_table_is_the_float32_cast_of_the_python_expressions(name):
    cfg = tcfg.preset(name)
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, samples=5000))
    dim = 512 * 512
    table = est.sa_step_coefficients(cfg, dim)
    cast = torch.from_numpy(table).to(torch.float32).numpy()
    assert table.shape == (2 + sum(not s.fix for s in cfg.psf_params), 5001)
    assert not table[:, :2].any()
    for ii in range(2, 5001):
        assert table[:, ii].tolist() == _today(cfg, dim, ii)
        assert cast[:, ii].tolist() == np.float32(_today(cfg, dim, ii)).tolist()


def _run(problem, **kw):
    g = torch.Generator().manual_seed(4)
    return est.run_sapg(problem, noise=lambda shape: torch.randn(shape, generator=g), **kw)


@pytest.mark.parametrize("logs", [False, True], ids=["linear", "log-scales"])
@pytest.mark.parametrize("name", ["gaussian", "moffat"])
def test_table_step_equals_todays_formulas_bit_for_bit(name, logs, monkeypatch):
    cfg = _cfg(name, logs)
    problem = _problem(cfg)
    assert problem.cfg.psf_params[0].fix == (name == "gaussian")
    table = _run(problem)
    dim = problem.blur.dim
    monkeypatch.setattr(est, "_coefficients", lambda t, ii: _today(cfg, dim, ii))
    today = _run(problem)
    assert table.X_last.dtype == np.float32
    for a, b in [(table.thetas, today.thetas), (table.sigma2s, today.sigma2s),
                 (table.logPiTrace, today.logPiTrace), (table.X_last, today.X_last),
                 *[(table.psf_param_traces[n], today.psf_param_traces[n])
                   for n in table.psf_param_traces]]:
        assert np.array_equal(a, b)
    # θ moved every iteration (σ² and the PSF parameters may sit at an end of their box)
    assert len(np.unique(table.thetas)) == len(table.thetas)


def _run_of(problems, chains):
    layout = RankLayout(problems=range(len(problems)), rows=slice(0, chains),
                        device=torch.device("cpu"))
    return est.SAPGRun(problems, layout, warmup=5, samples=12)


@pytest.mark.parametrize("D", [1, 2], ids=["one problem", "two problems"])
@pytest.mark.parametrize("name", ["gaussian", "moffat"])
def test_device_indices_give_the_host_index_results(name, D):
    cfg = _cfg(name, samples=12, warmup=5)
    problems = [_problem(cfg), build_problem(synthetic_wheel(SIZE), cfg, dtype=torch.float32,
                                             device="cpu", noise=np.ones((SIZE, SIZE)))][:D]
    C = 2
    g = torch.Generator().manual_seed(3)
    Zs = [torch.randn((D * C, SIZE, SIZE), generator=g) for _ in range(15)]
    outs = []
    for device_index in (False, True):
        run = _run_of(problems, C)
        its = run.iterations
        at = (lambda i: torch.tensor([i])) if device_index else (lambda i: i)
        carry = run.start(run.init_x())
        for t in range(4):
            carry = its.warm_iter(carry, at(t), Zs[t])
        carry = run.aux["main_carry"](carry, run.consts)
        for ii in range(2, 13):
            carry = its.main_iter(carry, at(ii), Zs[ii + 2])
        outs.append([its.logpi_wu.clone(), its.buf[..., 2:].clone(), carry[0], carry[3],
                     carry[4], *carry[5].values()])
        traces = its.traces(range(2, 13))
        assert traces["theta"].shape == (11, D) and carry[3].shape == (D,)
        np.testing.assert_array_equal(traces["theta"], its.buf[its.names.index("theta"), :, 2:]
                                      .numpy().T)
    assert all(torch.equal(a, b) for a, b in zip(*outs))


class _CountOps(TorchDispatchMode):
    """The non-view aten operations dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


# (warm-up, SAPG) iteration of the one-card step that carried θ, σ² and the
# PSF parameters as 0-d tensors, counted as below on the code before the one
# run loop, B = 1 and 16 alike; the problem-batched step then added 4 clones
# and 5 (Gaussian) or 8 (Moffat) stacks to these for a batch of one problem
PARENT_OPS = {"gaussian": (23, 43), "moffat": (23, 136)}


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("name", ["gaussian", "moffat"])
def test_one_problem_iteration_dispatches_the_parents_ops(name, B, monkeypatch):
    """The spatial segment's plain version stands for the kernel, one
    launch on the card: it runs outside the count, and is counted apart."""
    cfg = _cfg(name, samples=12, warmup=5)
    problem = _problem(cfg)
    assert problem.cfg.psf_params[0].fix == (name == "gaussian")
    kernel, calls = est.myula_prox_tv_plain, []

    def one_launch(*a, **k):
        calls.append(1)
        with _disable_current_modes():
            return kernel(*a, **k)

    monkeypatch.setattr(est, "myula_prox_tv_plain", one_launch)
    run = _run_of([problem], B)
    its = run.iterations
    g = torch.Generator().manual_seed(1)
    carry = its.warm_iter(run.start(run.init_x()), 0, torch.randn((B, SIZE, SIZE), generator=g))
    Z = torch.randn((B, SIZE, SIZE), generator=g)
    with _CountOps() as warm:
        carry = its.warm_iter(carry, 1, Z)
    carry = its.main_iter(run.aux["main_carry"](carry, run.consts), 2,
                          torch.randn((B, SIZE, SIZE), generator=g))
    Z = torch.randn((B, SIZE, SIZE), generator=g)
    with _CountOps() as main:
        its.main_iter(carry, 3, Z)
    assert len(calls) == 4
    assert (sum(warm.ops.values()), sum(main.ops.values())) == PARENT_OPS[name], (warm.ops,
                                                                                 main.ops)


CUDA = torch.device("cuda")
ENGAGE = [
    ("the rule's case", dict(), True),
    ("cpu", dict(device="cpu"), False),
    ("plain route", dict(route="plain"), False),
    ("route G", dict(route="G"), False),
    ("route I", dict(route="I"), False),
    ("dft", dict(fft_mode="dft"), False),
    ("in-kernel noise", dict(in_kernel_rng=True), False),
    ("Welford", dict(track_posterior_moments=True), False),
    ("unfused step", dict(use_fused_step=False), False),
]


@pytest.mark.parametrize("case,kw,want", ENGAGE, ids=[c[0] for c in ENGAGE])
def test_graph_replay_rule(case, kw, want):
    sapg = dataclasses.replace(tcfg.gaussian_preset().sapg, **{
        k: v for k, v in kw.items() if k in ("in_kernel_rng", "track_posterior_moments",
                                             "use_fused_step")})
    got = est.resolve_graph_replay(sapg, kw.get("route", "B"), kw.get("fft_mode", "fft"),
                                   kw.get("device", CUDA), (512, 512), 1)
    assert got is want


def test_eager_run_counts_eager_steps_and_never_captures():
    problem = _problem(_cfg("gaussian", samples=12, warmup=5))
    profiling.counters.reset("graph.eager_steps", "graph.replays", "graph.captures")
    _run(problem)
    assert profiling.counters["graph.eager_steps"] == 4 + 11
    assert profiling.counters["graph.replays"] == profiling.counters["graph.captures"] == 0
    assert problem.step_graphs == {}


def test_a_capture_reports_its_chain_groups_once_a_replay():
    """`groups.<kernel>` (the chain groups a resident launch ran one after
    another) leaves the counters during a capture, as `launches.*` does,
    and each replay adds the captured launch's groups."""
    c = profiling.counters
    profiling.reset()
    try:
        with profiling.capturing() as cap:
            c.add("launches.B")
            c.add("groups.B", 3)
        assert c["groups.B"] == c["launches.B"] == 0
        assert cap.launches == {"launches.B": 1, "groups.B": 3}
        for _ in range(4):
            profiling.replayed(cap)
        assert c["launches.B"] == 4 and c["groups.B"] == 12
    finally:
        profiling.reset()


def test_a_capture_reports_its_launches_and_sweeps_once_a_replay():
    c = profiling.counters
    profiling.reset()
    c.add("launches.B", 3)
    iters = torch.tensor([25, 7], dtype=torch.int32)
    with profiling.capturing() as cap:
        c.add("launches.B")
        c.add("launches.A", 2)
        profiling.count_sweeps("B", iters)
    assert c["launches.B"] == 3 and c["launches.A"] == 0
    assert cap.launches == {"launches.B": 1, "launches.A": 2}
    assert cap.sweeps == [("B", iters)] and c["chain_calls.B"] == 0
    profiling.replayed(cap)            # recorder off: launches only
    assert c["launches.B"] == 4 and c["launches.A"] == 2 and c["chain_calls.B"] == 0
    profiling.enable(in_sessions=False)
    try:
        profiling.replayed(cap)
        iters[1] = 3                   # the graph's buffer, rewritten by the next replay
        profiling.replayed(cap)
        assert c["launches.B"] == 6 and c["launches.A"] == 6
        assert c["chain_calls.B"] == 4 and c["sweeps.B"] == 25 + 7 + 25 + 3
    finally:
        profiling.disable()
        profiling.reset()
