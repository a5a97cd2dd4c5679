"""`estimator.stats_fused_share(.b16)`: the share of the SAPG iterations
whose Parseval statistics ran as the hand-written kernel, from the
program's `launches.sapg_stats`, `graph.replays` and `graph.eager_steps`
counters.

On synthetic snapshots the readers give 100 · launches / (replays + eager),
and None where there is nothing to read (no recorder, no such counter: a
tree from before the kernel, or a run on the CPU, where the plain version
runs and no kernel is launched, so a traced run leaves the metric out)."""
import pytest

from portbench import harness, program_spans
from portbench.tests.test_portbench_spans import armed  # noqa: F401  (a fixture)

NAMES = ("estimator.stats_fused_share", "estimator.stats_fused_share.b16")


def readers():
    bench = harness.manifest()
    return [harness.reader(harness.entry(bench["per_layer"], n)) for n in NAMES]


@pytest.mark.parametrize("counts,share", [
    # two runs of 3,498 iterations, all but each kind's first replayed, and
    # logπ at each warm-up's end
    ({"launches.sapg_stats": 6998, "graph.replays": 6992, "graph.eager_steps": 4},
     100.0 * 6998 / 6996),
    ({"launches.sapg_stats": 13, "graph.eager_steps": 12}, 100.0 * 13 / 12),
    ({"launches.sapg_stats": 5, "graph.replays": 10}, 50.0),
    ({"graph.replays": 6992, "graph.eager_steps": 4}, None),   # the parent: no kernel
    ({"launches.sapg_stats": 3}, None),
    ({}, None),
])
def test_the_share_from_the_counters(monkeypatch, counts, share):
    snap = {"spans": [], "totals": {}, "counters": counts}
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    for r in readers():
        got = r.read({})
        assert got == (None if share is None else pytest.approx(share))


def test_without_the_recorder_the_share_reads_none(monkeypatch):
    monkeypatch.setattr(program_spans, "_ARMED", [])
    for r in readers():
        assert r.read({}) is None


@pytest.mark.parametrize("name,cells,moves", [
    (NAMES[0], ["gaussian512-b1", "moffat512-b1"], "chain_iter_per_s"),
    (NAMES[1], ["gaussian512-b16"], "chain_iter_per_s.b16"),
])
def test_the_metrics_cells(name, cells, moves):
    bench = harness.manifest()
    m = harness.entry(bench["per_layer"], name)
    assert m["workloads"] == cells and m["source"] == "program_counter"
    assert m["moves"] == moves and m["layer"] == "sapg/estimator"
    for cell in cells:
        assert moves in [e["name"] for e in harness.end_to_end(bench, cell)]


@pytest.mark.parametrize("workload", ["gaussian512-b1", "gaussian512-b16"])
def test_a_traced_cpu_run_leaves_the_metrics_out(armed, workload):  # noqa: F811
    out = harness.run(workload, 2147483659, 0.0, True, device="cpu")
    assert out["correct"]
    assert not set(NAMES) & set(out["metrics"])
