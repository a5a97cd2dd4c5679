"""The arithmetic of the per-layer metrics, over what a window driver hands
them (`reading()`): the profiled slice's `trace` (profile.Trace, or None
where every session came back empty), the `iterations` in it, the `chains`,
the image's `shape`, and the `sweeps` a prox call that the reference ran on
the cell's inputs.  Each metric's own file (portbench/metrics/<name>.py)
names its unit, layer and kernels and calls one of these; each returns None
where it finds nothing to read, never 0."""
from __future__ import annotations

from portbench.work import PEAK_FP32, bound, salsa_iter_work, sapg_iter_work


def launches_per_iter(r):
    """CUDA launch calls the host made an iteration."""
    if r["trace"] is None or not r["trace"].launches():
        return None
    return r["trace"].launches() / r["iterations"]


def idle_share(r):
    """% of the slice in which no operation ran on the device."""
    if r["trace"] is None:
        return None
    return 100.0 * (1.0 - r["trace"].busy_s / r["trace"].window_s)


def kernel_ms_per_iter(r, patterns):
    """Device ms an iteration of the kernels matching `patterns`."""
    if r["trace"] is None:
        return None
    us = r["trace"].kernel_us(patterns)
    return us / r["iterations"] / 1e3 if us > 0 else None


def roofline(r, patterns, work):
    """% of its roofline: work(r) = the (operations, bytes) of one call of
    the kernels matching `patterns`, one call an iteration, over their
    device time an iteration."""
    if r["trace"] is None or not r["sweeps"]:
        return None
    us = r["trace"].kernel_us(patterns) / r["iterations"]
    if us <= 0:
        return None
    return 100.0 * bound(work(r))["bound_ms"] * 1e3 / us


def mfu(r):
    """% of the float32 peak: the operations of the slice's iterations,
    counted from their shapes (work.py), over the slice's length."""
    if r["trace"] is None or not r["sweeps"]:
        return None
    if r["kind"] == "sapg":
        ops = sapg_iter_work(r["chains"], *r["shape"], r["sweeps"])
    else:
        ops = salsa_iter_work(*r["shape"], r["sweeps"])
    return 100.0 * ops * r["iterations"] / (r["trace"].window_s * PEAK_FP32)
