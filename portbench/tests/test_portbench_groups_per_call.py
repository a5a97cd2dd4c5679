"""`kernel.groups_per_call.b16`: the chain groups kernel B ran one after
another a call at B = 16, from the program's `groups.B` and `launches.B`
counters.

On synthetic snapshots the reader gives groups.B / launches.B, and None
where there is nothing to read (no recorder, no such counters: a tree from
before them, or a run that launched no kernel B).  On the CPU at 32² the
plain version runs and no kernel is launched, so a traced run leaves the
metric out."""
import pytest

from portbench import harness, program_spans
from portbench.tests.test_portbench_spans import armed  # noqa: F401  (a fixture)

NAME = "kernel.groups_per_call.b16"


def reader():
    return harness.reader(harness.entry(harness.manifest()["per_layer"], NAME))


@pytest.mark.parametrize("counts,groups", [
    ({"groups.B": 8 * 3499, "launches.B": 3499}, 8.0),            # one chain a block
    ({"groups.B": 3 * 3499, "launches.B": 3499, "launches.A": 2}, 3.0),  # three a block
    ({"groups.B": 5, "launches.B": 2}, 2.5),
    ({"launches.B": 12}, None),                                   # a tree from before the counter
    ({"groups.A": 4, "launches.A": 4}, None),
    ({}, None),
])
def test_groups_a_call_from_the_counters(monkeypatch, counts, groups):
    snap = {"spans": [], "totals": {}, "counters": counts}
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    got = reader().read({})
    assert got == (None if groups is None else pytest.approx(groups))


def test_without_the_recorder_the_groups_read_none(monkeypatch):
    monkeypatch.setattr(program_spans, "_ARMED", [])
    assert reader().read({}) is None


def test_the_metric_is_the_b16_cells_alone():
    bench = harness.manifest()
    m = harness.entry(bench["per_layer"], NAME)
    assert m["workloads"] == ["gaussian512-b16"] and m["source"] == "program_counter"
    assert [e["name"] for e in harness.end_to_end(bench, "gaussian512-b16")
            if e["name"] == m["moves"]] == ["chain_iter_per_s.b16"]


def test_a_traced_cpu_run_leaves_the_metric_out(armed):  # noqa: F811
    out = harness.run("gaussian512-b16", 2147483659, 0.0, True, device="cpu")
    assert out["correct"]
    assert NAME not in out["metrics"]
