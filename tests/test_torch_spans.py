"""The port's spans and counters (runtime/profiling.py) on the CPU.

* off, `span()` is one shared no-op and nothing is recorded, by a run too;
* on, the nesting, the parents and the self times, and the bound on what is
  kept (the rest in per-name totals, counted as `spans.dropped`);
* inside a torch.profiler session (`profiling.trace`) the spans are
  `user_annotation` events with the same nesting and durations, and a span
  that straddles the session's start or stop is not in its file; kept still
  in sessions (`enable(in_sessions=False)`), it records nothing there;
* a 32² `run_sapg` records one `sapg.step` a main iteration and one
  `sapg.warm_step` a warm-up step, with their children, and `psf.otf` only
  where a PSF parameter is free; the sharded path records the same names;
* `sweeps.<kernel>` holds the plain prox's sweep counts; `salsa_tv`'s
  `salsa.iter` and `kernel.prox`; the launch counters' registry;
* `run_demo --spans --out DIR` writes spans.json, a Chrome trace.

No JAX: the module runs in spawned worker processes too.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from semiblind_tv_tpu_torch.cli import run_demo as t_cli
from semiblind_tv_tpu_torch.ops.fused_step_cuda import myula_prox_tv
from semiblind_tv_tpu_torch.ops.tv import chambolle_prox
from semiblind_tv_tpu_torch.runtime import config as tcfg
from semiblind_tv_tpu_torch.runtime import profiling
from semiblind_tv_tpu_torch.runtime.problem import build_problem
from semiblind_tv_tpu_torch.sapg.estimator import run_sapg
from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv
from semiblind_tv_tpu_torch.utils.images import synthetic_wheel

SIZE = 32
SAMPLES, WARMUP = 12, 5
STEP_CHILDREN = {"sapg.noise", "sapg.residual", "fourier.irfft", "kernel.step", "fourier.rfft",
                 "sapg.stats", "sapg.update", "sapg.trace"}


@pytest.fixture(autouse=True)
def recorder():
    """A recorder reset and off around each test (and one torch thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    was = profiling.enabled()
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()
    if was:
        profiling.enable()
    torch.set_num_threads(n)


def _busy(seconds):
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


def _problem(cfg, samples=SAMPLES, warmup=WARMUP, size=SIZE):
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=samples, warmup=warmup, burn_in=(samples * 80) // 100))
    return build_problem(synthetic_wheel(size), cfg, torch.Generator().manual_seed(3),
                         dtype=torch.float64, device="cpu")


def _names(snap):
    out = {}
    for s in snap["spans"]:
        out[s["name"]] = out.get(s["name"], 0) + 1
    return out


def _children(snap, parent_name):
    """{child name: count} of the spans whose parent is a `parent_name`."""
    ids = {s["id"] for s in snap["spans"] if s["name"] == parent_name}
    out = {}
    for s in snap["spans"]:
        if s["parent"] in ids:
            out[s["name"]] = out.get(s["name"], 0) + 1
    return out


def test_off_is_one_shared_no_op_and_records_nothing(recorder):
    a, b = recorder.span("a"), recorder.span("b")
    assert a is b
    with a as entered:
        assert entered is a
        with recorder.span("c"):
            pass
    recorder.count_sweeps("B", torch.tensor([3, 4], dtype=torch.int32))
    run_sapg(_problem(tcfg.gaussian_preset(), samples=4, warmup=3),
             torch.Generator().manual_seed(1))
    snap = recorder.snapshot()
    assert snap["spans"] == [] and snap["totals"] == {}
    assert not any(k.startswith(("sweeps.", "chain_calls.")) for k in snap["counters"])


def test_nesting_parents_and_self_time(recorder):
    recorder.enable()
    with recorder.span("outer"):
        _busy(0.004)
        with recorder.span("inner"):
            _busy(0.006)
        with recorder.span("inner"):
            with recorder.span("leaf"):
                _busy(0.002)
    snap = recorder.snapshot()
    by = {}
    for s in snap["spans"]:
        by.setdefault(s["name"], []).append(s)
    (outer,), inners, (leaf,) = by["outer"], by["inner"], by["leaf"]
    assert outer["parent"] == -1 and all(s["parent"] == outer["id"] for s in inners)
    assert leaf["parent"] == inners[1]["id"]
    for s in snap["spans"]:
        assert s["end_ns"] >= s["start_ns"] and not s["profiled"]
    dur = {n: sum(s["end_ns"] - s["start_ns"] for s in v) for n, v in by.items()}
    assert outer["child_ns"] == dur["inner"]
    assert snap["totals"]["outer"]["self_ns"] == dur["outer"] - dur["inner"]
    assert snap["totals"]["inner"] == {"count": 2, "total_ns": dur["inner"],
                                       "self_ns": dur["inner"] - dur["leaf"]}
    assert 4e6 <= snap["totals"]["outer"]["self_ns"] < dur["outer"]


def test_the_bound_keeps_totals_and_counts_drops(recorder, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    recorder.enable()
    with recorder.span("root"):
        for _ in range(9):
            with recorder.span("leaf"):
                pass
    snap = recorder.snapshot()
    assert len(snap["spans"]) == 5 and _names(snap) == {"leaf": 5}
    assert snap["counters"]["spans.dropped"] == 5
    assert snap["totals"]["leaf"]["count"] == 9 and snap["totals"]["root"]["count"] == 1
    leaves = snap["totals"]["leaf"]["total_ns"]
    assert snap["totals"]["root"]["total_ns"] - snap["totals"]["root"]["self_ns"] == leaves


def test_profiler_session_holds_the_spans_as_annotations(recorder, tmp_path):
    recorder.enable()
    with recorder.span("before"):           # opens before the session: left out
        with profiling.trace(str(tmp_path)):
            with recorder.span("outer"):
                _busy(0.01)
                for _ in range(2):
                    with recorder.span("inner"):
                        _busy(0.02)
            straddle = recorder.span("straddle")   # still open when the session stops
            straddle.__enter__()
        straddle.__exit__(None, None, None)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    assert sorted(e["name"] for e in events) == ["inner", "inner", "outer"]
    snap = recorder.snapshot()
    mine = {s["name"]: s for s in snap["spans"]}
    assert mine["outer"]["profiled"] and mine["straddle"]["profiled"]
    assert not mine["before"]["profiled"]
    outer = next(e for e in events if e["name"] == "outer")
    for e in events:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    trace_us = sorted(e["dur"] for e in events if e["name"] == "inner")
    mem_us = sorted((s["end_ns"] - s["start_ns"]) / 1e3 for s in snap["spans"]
                    if s["name"] == "inner")
    for t, m in zip(trace_us + [outer["dur"]],
                    mem_us + [(mine["outer"]["end_ns"] - mine["outer"]["start_ns"]) / 1e3]):
        assert abs(t - m) <= 0.05 * m


def test_a_recorder_kept_still_in_sessions_leaves_them_as_off(recorder, tmp_path):
    off = recorder.span("off")
    recorder.enable(in_sessions=False)
    with recorder.span("around"):           # around the whole session: kept
        straddle = recorder.span("straddle")   # open as the session starts: kept, profiled
        straddle.__enter__()
        with profiling.trace(str(tmp_path)):
            straddle.__exit__(None, None, None)
            inside = recorder.span("inside")
            with inside:
                recorder.count_sweeps("B", torch.tensor([3, 4], dtype=torch.int32))
    assert inside is off                    # the shared no-op, as with the recorder off
    with recorder.span("after"):
        recorder.count_sweeps("B", torch.tensor([5], dtype=torch.int32))
    with open(tmp_path / profiling.TRACE_FILE) as f:
        assert not [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    snap = recorder.snapshot()
    assert {s["name"]: s["profiled"] for s in snap["spans"]} == {
        "around": False, "straddle": True, "after": False}
    assert snap["counters"]["sweeps.B"] == 5 and snap["counters"]["chain_calls.B"] == 1
    mine = {s["name"]: s for s in snap["spans"]}
    assert mine["straddle"]["end_ns"] < snap["still_from_ns"] < mine["after"]["start_ns"]


@pytest.mark.parametrize("psf,otf_spans", [("gaussian", 0), ("moffat", SAMPLES - 1)])
def test_run_records_a_step_a_main_iteration(recorder, psf, otf_spans):
    recorder.enable()
    problem = _problem(tcfg.preset(psf))
    run_sapg(problem, torch.Generator().manual_seed(1), n_chains=2)
    snap = recorder.snapshot()
    names = _names(snap)
    main, warm = SAMPLES - 1, WARMUP - 1
    assert names["sapg.step"] == main and names["sapg.warm_step"] == warm
    for one in ("sapg.run", "sapg.prologue", "sapg.warmup", "sapg.segment", "sapg.assemble"):
        assert names[one] == 1, one
    assert _children(snap, "sapg.run") == {"sapg.prologue": 1, "sapg.warmup": 1,
                                           "sapg.segment": 1, "sapg.assemble": 1}
    kids = _children(snap, "sapg.step")
    assert kids.pop("psf.otf", 0) == otf_spans
    assert kids == {n: main for n in STEP_CHILDREN}
    assert _children(snap, "sapg.warm_step") == {n: warm for n in STEP_CHILDREN - {"sapg.update"}}
    assert names.get("psf.otf", 0) == otf_spans
    # route 'plain' on the CPU: the step's prox counts as kernel B's, two chains a call
    c = snap["counters"]
    assert c["chain_calls.B"] == 2 * (main + warm) and c["chain_calls.A2"] == 2
    assert 2 * (main + warm) <= c["sweeps.B"] <= 25 * c["chain_calls.B"]


def test_sweeps_counter_is_the_plain_prox_sweeps(recorder):
    rng = np.random.default_rng(0)
    shape = (3, 24, 20)
    recorder.enable()
    expected = 0
    for k in range(4):
        x = torch.from_numpy(rng.random(shape) * 255)
        prox, grad = x + 0.1 * torch.from_numpy(rng.standard_normal(shape)), 0.01 * x
        z = torch.from_numpy(rng.standard_normal(shape))
        lam_theta = 0.02 * 10 ** k
        xn = myula_prox_tv(x, prox, grad, z, 1.9, 2.0, lam_theta, 25, tol=1e-3)[0]
        expected += int(chambolle_prox(xn, lam_theta, 25, tol=1e-3)[1].iters.sum())
    c = recorder.snapshot()["counters"]
    assert c["sweeps.B"] == expected and c["chain_calls.B"] == 4 * 3
    assert 0 < expected < 25 * 12


def test_salsa_iterations_and_their_prox(recorder):
    problem = _problem(tcfg.gaussian_preset())
    recorder.enable()
    res = salsa_tv(problem.y, problem.H_true, tau=0.05, mu=0.01, blur=problem.blur,
                   max_iter=7, tol=0.0, tv_iters=10)
    snap = recorder.snapshot()
    assert _names(snap) == {"salsa.iter": 7, "kernel.prox": 7}
    assert _children(snap, "salsa.iter") == {"kernel.prox": 7}
    c = snap["counters"]
    assert c["chain_calls.A1"] == 7 and 7 <= c["sweeps.A1"] <= 70
    assert res.n_iters == 7


def test_counter_registry():
    c = profiling.Counters()
    c.add("launches.B")
    c.add("launches.B", 2)
    c.add("launches.A")
    assert c["launches.B"] == 3 and c["launches.D"] == 0
    c.reset("launches.B")
    assert c.snapshot() == {"launches.A": 1}
    c.reset()
    assert c.snapshot() == {}


def test_export_writes_a_chrome_trace(recorder, tmp_path):
    recorder.enable()
    with recorder.span("a"):
        with recorder.span("b"):
            pass
    recorder.counters.add("launches.B", 4)
    snap = recorder.export(str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as f:
        data = json.load(f)
    spans = [e for e in data["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["b", "a"] and all(e["dur"] >= 0 for e in spans)
    (counter,) = [e for e in data["traceEvents"] if e["ph"] == "C"]
    assert counter["args"]["launches.B"] == 4 == snap["counters"]["launches.B"]
    assert data["otherData"]["totals"]["a"]["count"] == 1


def test_cli_spans_writes_spans_json(recorder, tmp_path, capsys):
    out = tmp_path / "demo"
    t_cli.main(["--device", "cpu", "--image", "synthetic", "--size", "32", "--samples", "8",
                "--warmup", "4", "--f64", "--out", str(out), "--spans"])
    assert not recorder.enabled()
    with open(out / t_cli.SPANS_FILE) as f:
        data = json.load(f)
    names = [e["name"] for e in data["traceEvents"] if e["ph"] == "X"]
    assert names.count("sapg.step") == 7 and names.count("sapg.warm_step") == 3
    assert names.count("sapg.run") == 1 and names.count("salsa.iter") >= 1
    (counter,) = [e for e in data["traceEvents"] if e["ph"] == "C"]
    assert counter["args"]["chain_calls.B"] == 10
    with pytest.raises(SystemExit):
        t_cli.main(["--device", "cpu", "--spans"])


def _sharded_spans(rank):
    from semiblind_tv_tpu_torch.parallel.mesh import make_mesh

    profiling.reset()
    profiling.enable()
    torch.set_num_threads(1)
    mesh = make_mesh(1, 1, device_type="cpu")
    run_sapg(_problem(tcfg.preset("moffat"), size=16), torch.Generator().manual_seed(1),
             n_chains=2, mesh=mesh)
    snap = profiling.snapshot()
    return _names(snap), _children(snap, "sapg.run"), _children(snap, "sapg.step")


def test_sharded_path_records_the_same_names():
    from semiblind_tv_tpu_torch.runtime.distributed import spawn

    (names, run_kids, step_kids), = spawn(_sharded_spans, 1, timeout=120)
    assert run_kids == {"sapg.prologue": 1, "sapg.warmup": 1, "sapg.segment": 1,
                        "sapg.assemble": 1}
    assert names["sapg.step"] == SAMPLES - 1 and names["sapg.warm_step"] == WARMUP - 1
    assert step_kids == {n: SAMPLES - 1 for n in STEP_CHILDREN | {"psf.otf"}}
