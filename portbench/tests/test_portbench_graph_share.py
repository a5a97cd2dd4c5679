"""`estimator.graph_step_share(.b16)`: the share of the SAPG iterations
that ran as a CUDA graph's replay, from the program's `graph.replays` and
`graph.eager_steps` counters.

On synthetic snapshots the readers give 100 · replays / (replays + eager),
and None where there is nothing to read (no recorder, no such counters: a
tree from before them).  On the CPU at 32², where every iteration runs
eagerly, a traced run reports 0 in the cells that list the metric."""
import pytest

from portbench import harness, program_spans
from portbench.tests.test_portbench_spans import armed  # noqa: F401  (a fixture)

NAMES = ("estimator.graph_step_share", "estimator.graph_step_share.b16")


def readers():
    bench = harness.manifest()
    return [harness.reader(harness.entry(bench["per_layer"], n)) for n in NAMES]


@pytest.mark.parametrize("counts,share", [
    ({"graph.replays": 6994, "graph.eager_steps": 6}, 100.0 * 6994 / 7000),
    ({"graph.eager_steps": 12}, 0.0),
    ({"graph.replays": 3}, 100.0),
    ({"launches.B": 12}, None),
    ({}, None),
])
def test_the_share_of_replayed_iterations(monkeypatch, counts, share):
    snap = {"spans": [], "totals": {}, "counters": counts}
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    for r in readers():
        got = r.read({})
        assert got == (None if share is None else pytest.approx(share))


def test_without_the_recorder_the_share_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "_ARMED", [])
    for r in readers():
        assert r.read({}) is None


@pytest.mark.parametrize("workload,name", [
    ("gaussian512-b1", "estimator.graph_step_share"),
    ("gaussian512-b16", "estimator.graph_step_share.b16"),
])
def test_a_traced_cpu_run_reads_every_iteration_eager(armed, workload, name):  # noqa: F811
    out = harness.run(workload, 2147483659, 0.0, True, device="cpu")
    assert out["correct"]
    assert out["metrics"][name]["value"] == 0.0
    assert not (set(NAMES) - {name}) & set(out["metrics"])
