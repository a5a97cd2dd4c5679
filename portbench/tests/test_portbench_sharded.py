"""The four-card cell's pieces: the sharded driver is found by name and
starts no process until its set-up, the configuration is the published
Gaussian demo number for number with a 1×4 mesh, the blocked reference is
reference/sapg.run with its chains in blocks, and the new readers return
None where they find nothing to read."""
import json
import os

import pytest
import torch

from portbench import compare, harness, inputs, port
from portbench.reference import problem as refproblem
from portbench.reference import sapg as refsapg
from portbench.reference import sapg_blocks

CELL = "gaussian512-b64-4chip"
F64 = torch.float64
READERS = ["collective.allreduce_ms_per_iter.4chip", "collective.allreduce_per_iter.4chip",
           "sapg.noise_kept_share.4chip", "parallel.gather_ms.4chip",
           "device.idle_share.sapg.4chip", "mfu.sapg.4chip", "estimator.step_host_ms.4chip",
           "estimator.launches_per_iter.4chip", "estimator.run_gap_ms.4chip",
           "fourier.fft_ms_per_iter.4chip", "kernel.step_roofline.4chip",
           "kernel.sweeps_per_call.4chip"]


def config(name):
    with open(os.path.join(harness.ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_the_driver_is_found_by_name_and_starts_no_process():
    import multiprocessing

    before = set(multiprocessing.active_children())
    c = harness.cell(harness.manifest(), CELL, 2 ** 31 + 5, "cpu")
    d = harness.driver(c)
    assert type(d).__module__ == "portbench_driver_sapg_sharded_runs"
    assert (d.B, d.ranks) == (64, 4) and d.world is None
    assert set(multiprocessing.active_children()) == before
    assert c.chips == 4 and c.traffic["driver"] == "sapg_sharded_runs"


def test_the_configuration_is_the_published_demo_on_a_1x4_mesh():
    one, four = config("gaussian-wheel-512"), config("gaussian-wheel-512-mesh1x4")
    assert four["demo"] == one["demo"]
    assert four["sapg_options"] == one["sapg_options"]
    assert four["mesh"] == {"data": 1, "chains": 4}
    assert port.demo_config(four).sapg.samples == four["demo"]["samples"]
    entry = harness.entry(harness.manifest()["configs"], four["name"])
    assert entry["reduced"] == ["samples", "warmup"] and entry["source"] == four["source"]


@pytest.mark.parametrize("name", ["gaussian-wheel-512-mesh1x4", "moffat-wheel-512"])
def test_the_blocked_reference_is_the_reference(name):
    c = config(name)
    c["demo"].update(samples=4, warmup=3, burn_in=3)
    img = inputs.image(c["image"])[180:220, 150:206]
    obs = inputs.normal_field(inputs.derive(3, "observation"), img.shape, "cpu", F64)
    prob = refproblem.build(img, c["demo"], obs)
    seed = inputs.derive(3, "chains", 0)
    one = refsapg.run(prob, c["demo"], 8, inputs.Draws(seed, "cpu", F64))
    four = sapg_blocks.run(prob, c["demo"], 8, inputs.Draws(seed, "cpu", F64), ["cpu"] * 4)
    free = [p["name"] for p in c["demo"]["psf_params"] if not p["fix"]]
    for n in ["theta", "sigma2"] + free:
        assert compare.trace_gap(four[n], one[n]) < 1e-12, n
    assert compare.field_gap(four["X_last"], one["X_last"]) < 1e-12
    assert four["sweeps"] == pytest.approx(one["sweeps"], rel=1e-12)
    assert len(four["block_sweeps"]) == 4 and sum(four["block_sweeps"]) == four["sweeps"]
    with pytest.raises(ValueError):
        sapg_blocks.run(prob, c["demo"], 6, inputs.Draws(seed, "cpu", F64), ["cpu"] * 4)


@pytest.mark.parametrize("name", READERS)
def test_the_readers_find_nothing_without_counters_or_trace(name):
    bench = harness.manifest()
    metric = harness.entry(bench["per_layer"], name)
    assert metric["workloads"] == [CELL]
    reading = {"kind": "sapg", "trace": None, "iterations": 128, "chains": 16,
               "shape": (512, 512), "sweeps": None}
    assert harness.reader(metric).read(reading) is None
