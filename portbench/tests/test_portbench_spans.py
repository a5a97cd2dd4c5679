"""The per-layer metrics of the program's own spans and counters
(portbench/program_spans.py, the readers that arm it).

On synthetic snapshots: medians leave the profiled slice and what follows
the first session out, the run gap
counts only full runs, sweeps a call are a ratio of two counters, and
nothing to read gives None.  A program without the recorder (a tree from
before it) arms nothing and reads None; a reader loaded outside a traced
run arms nothing.  Each idle gap of a session is named by the innermost
span at its middle (`portbench/annotations.py`).  A profiler session whose Chrome
trace also holds `user_annotation` events (the spans, where a session
records them) reads the same numbers in every existing reader as one
without them.  On the CPU at 32², a traced run reports the new metrics of
each cell, held or not, and nothing else of them."""
import json

import pytest

from portbench import harness, inputs, profile, program_spans

NEW = {"estimator.step_host_ms", "estimator.psf_otf_host_ms", "estimator.run_gap_ms",
       "estimator.run_gap_ms.b16", "kernel.sweeps_per_call", "kernel.sweeps_per_call.b16",
       "salsa.iter_host_ms"}


def span(name, id, parent, start_ms, end_ms, profiled=False):
    return {"name": name, "id": id, "parent": parent, "start_ns": int(start_ms * 1e6),
            "end_ns": int(end_ms * 1e6), "child_ns": 0, "profiled": profiled}


def synthetic(late=1.5):
    """Two full runs (one with a profiled step) and the set-up's short run;
    the unprofiled steps of the runs from 100 ms on take `late` ms."""
    spans, nid = [], [0]

    def add(name, parent, a, b, profiled=False):
        nid[0] += 1
        spans.append(span(name, nid[0], parent, a, b, profiled))
        return nid[0]

    for t0, steps, gap, slow in ((0.0, 3, 10.0, False), (100.0, 3, 12.0, True),
                                 (200.0, 1, 50.0, False)):
        run = add("sapg.run", -1, t0, t0 + gap + 4.0 + 2.0 * steps)
        add("sapg.warmup", run, t0 + 1.0, t0 + 5.0)
        seg = add("sapg.segment", run, t0 + 5.0, t0 + 5.0 + 2.0 * steps)
        for k in range(steps):
            profiled = slow and k == 1
            dur = 9.0 if profiled else 1.5 if t0 < 100.0 else late
            add("sapg.step", seg, t0 + 5 + 2 * k, t0 + 5 + 2 * k + dur, profiled)
    return {"spans": spans, "totals": {},
            "counters": {"sweeps.B": 150, "chain_calls.B": 12, "launches.B": 12}}


def test_readers_on_a_synthetic_snapshot():
    snap = synthetic()
    assert program_spans.median_ms("sapg.step", snap) == pytest.approx(1.5)
    assert program_spans.median_ms("psf.otf", snap) is None
    assert program_spans.run_gap_ms(snap) == pytest.approx(11.0)   # the short run left out
    assert program_spans.sweeps_per_call("B", snap) == pytest.approx(12.5)
    assert program_spans.sweeps_per_call("C", snap) is None
    slow = synthetic(late=4.0)
    assert program_spans.median_ms("sapg.step", slow) == pytest.approx(2.75)
    # the recorder stood still for a session from 100 ms on: only the spans before
    slow["still_from_ns"] = int(100e6)
    assert program_spans.median_ms("sapg.step", slow) == pytest.approx(1.5)
    empty = {"spans": [], "totals": {}, "counters": {}}
    assert program_spans.run_gap_ms(empty) is None and program_spans.median_ms("x", empty) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "_ARMED", [])
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    bench = harness.manifest(held=True)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert harness.reader(m).read({}) is None, m["name"]
    assert program_spans._ARMED == []


def test_a_reader_loaded_outside_a_run_leaves_the_recorder_alone(monkeypatch):
    from semiblind_tv_tpu_torch.runtime import profiling

    monkeypatch.setattr(program_spans, "_ARMED", [])
    was = profiling.enabled()
    profiling.disable()
    try:
        for m in harness.manifest(held=True)["per_layer"]:
            if m["name"] in NEW:
                assert harness.reader(m).read({}) is None, m["name"]
        assert not profiling.enabled() and program_spans._ARMED == []
    finally:
        if was:
            profiling.enable()


class FakeSession:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def session_events(annotated):
    """A two-iteration slice: host operators, launch calls, kernels; with
    `annotated`, the spans around them as user_annotation events."""
    ev = []

    def x(name, cat, ts, dur):
        ev.append({"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur})

    for k in range(2):
        t = 1000.0 * k
        if annotated:
            x("sapg.step", "user_annotation", t, 900.0)
            x("kernel.step", "user_annotation", t + 100, 300.0)
            x("psf.otf", "user_annotation", t + 500, 200.0)
        x("aten::mul", "cpu_op", t + 120, 50.0)
        x("cudaLaunchKernel", "cuda_runtime", t + 130, 10.0)
        x("resident_step", "kernel", t + 150, 120.0)
        x("aten::pow", "cpu_op", t + 520, 60.0)
        x("cuLaunchKernel", "cuda_driver", t + 540, 8.0)
        x("void at::native::vectorized_elementwise_kernel<4>(float)", "kernel", t + 560, 30.0)
        x("regular_fft", "kernel", t + 800, 20.0)
    return ev


def test_existing_readers_read_the_same_with_annotations_in_the_session():
    traces = [profile.read(FakeSession(session_events(a))) for a in (False, True)]
    assert traces[0] == traces[1]
    bench = harness.manifest(held=True)
    for m in bench["per_layer"]:
        if m["source"] != "device_trace":
            continue
        r = [harness.reader(m).read({"kind": "map" if "map" in m["name"] else "sapg",
                                     "trace": t, "iterations": 2, "chains": 1,
                                     "shape": (512, 512), "sweeps": 12.0}) for t in traces]
        assert r[0] == r[1], m["name"]
    assert traces[0].idle_gaps() == traces[1].idle_gaps()
    assert traces[0].device_ops() == traces[1].device_ops()


@pytest.fixture
def armed(monkeypatch):
    """A fresh arm() for the test, and the recorder off and empty after it."""
    import torch

    from semiblind_tv_tpu_torch.runtime import profiling

    monkeypatch.setattr(program_spans, "_ARMED", [])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    full = inputs.image
    monkeypatch.setattr(inputs, "image", lambda name: full(name)[200:232, 200:232])
    real = harness.cell

    def cell(*args, **kw):
        c = real(*args, **kw)
        c.config["demo"].update(samples=30, warmup=15, burn_in=24)
        c.config["sapg_options"].update(samples=30, warmup=15)
        if "n_chains" in c.traffic:
            c.traffic["n_chains"] = min(c.traffic["n_chains"], 4)
        if "outer_iters" in c.traffic:
            c.traffic["outer_iters"] = 20
        return c

    monkeypatch.setattr(harness, "cell", cell)
    real_manifest = harness.manifest
    monkeypatch.setattr(harness, "manifest",
                        lambda root=harness.ROOT, held=True: real_manifest(root, held=True))
    yield
    profiling.disable()
    profiling.reset()
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,names", [
    ("gaussian512-b1", {"estimator.step_host_ms", "estimator.run_gap_ms",
                        "kernel.sweeps_per_call"}),
    ("moffat512-b1", {"estimator.step_host_ms", "estimator.psf_otf_host_ms",
                      "estimator.run_gap_ms", "kernel.sweeps_per_call"}),
    ("gaussian512-b16", {"estimator.run_gap_ms.b16", "kernel.sweeps_per_call.b16"}),
    ("gaussian512-map", {"salsa.iter_host_ms"}),
])
def test_a_traced_run_reports_the_span_metrics(armed, workload, names):
    out = harness.run(workload, 2147483659, 0.0, True, device="cpu")
    assert out["correct"]
    got = {n: v["value"] for n, v in out["metrics"].items() if n in NEW}
    assert set(got) == names
    for n, v in got.items():
        assert v > 0, n
    for n in names & {"kernel.sweeps_per_call", "kernel.sweeps_per_call.b16"}:
        assert 1 <= got[n] <= 25


def test_idle_gaps_are_named_by_the_innermost_span():
    from portbench import annotations

    events = session_events(True)
    trace, spans = annotations.read_with_spans(FakeSession(events))
    assert trace == profile.read(FakeSession(session_events(False)))
    assert sorted(n for n, _, _ in spans) == ["kernel.step"] * 2 + ["psf.otf"] * 2 + \
        ["sapg.step"] * 2
    idle = annotations.idle_spans(trace, spans)
    # the device runs 150-270, 560-590 and 800-820 of each iteration; the
    # slice's first gap (from the first host call at 120) has its middle in
    # kernel.step, each 270-560 in sapg.step outside kernel.step, each
    # 590-800 in psf.otf, and 820-1150 between the iterations in no span
    assert idle == pytest.approx({"kernel.step": 30e-6, "sapg.step": 2 * 290e-6,
                                  "psf.otf": 2 * 210e-6, "no span": 330e-6})
    assert sum(idle.values()) == pytest.approx(trace.window_s - trace.busy_s)
