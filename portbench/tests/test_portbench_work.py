"""work.py reproduces the bounds PERF.md's kernel table gives (H100, float32
peak 67 TFLOP/s, HBM 3.35 TB/s)."""
import pytest

from portbench.work import bound, prox_work, salsa_iter_work, sapg_iter_work, step_work


def test_step_bound_of_kernel_b():
    b = bound(step_work(1, 512, 512, 25))
    assert b["bound_ms"] * 1e3 == pytest.approx(2.63, abs=0.005)
    assert b["bound_by"] == "operations"


def test_warm_prox_bound_of_kernel_a1():
    b = bound(prox_work(1, 512, 512, 10, duals_io=True))
    assert b["bound_ms"] * 1e3 == pytest.approx(1.88, abs=0.005)
    assert b["bound_by"] == "bytes"


def test_whole_iterations_count_more_than_their_kernel():
    assert sapg_iter_work(16, 512, 512, 400) > step_work(16, 512, 512, 400)[0]
    assert salsa_iter_work(512, 512, 10) > prox_work(1, 512, 512, 10, duals_io=True)[0]


@pytest.mark.parametrize("kind", ["sapg", "map"])
def test_mfu_reads_the_traced_slice(kind):
    from portbench import readings
    from portbench.profile import Trace
    from portbench.work import PEAK_FP32

    tr = Trace(device=[("resident_step", 100.0, 600.0)], api=[], host=[("op", 0.0, 2000.0)])
    r = {"kind": kind, "trace": tr, "iterations": 8, "chains": 1, "shape": (512, 512),
         "sweeps": 12.5}
    ops = sapg_iter_work(1, 512, 512, 12.5) if kind == "sapg" else salsa_iter_work(512, 512, 12.5)
    assert readings.mfu(r) == pytest.approx(100.0 * ops * 8 / (2e-3 * PEAK_FP32))
    assert readings.idle_share(r) == pytest.approx(75.0)
    assert readings.mfu(dict(r, trace=None)) is None and readings.mfu(dict(r, sweeps=None)) is None
