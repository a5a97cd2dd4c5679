"""What the per-layer metrics of the program's own spans and counters read.

The program records named spans and counters while its recorder is on
(`semiblind_tv_tpu_torch/runtime/profiling.py`: `span`, `counters`,
`enable`, `snapshot`).  A traced run loads the readers of its per-layer
metrics before the window driver's set-up (`harness.run`), and each reader
of a metric in this family calls `arm()` as it is loaded: under
`harness.run`, and only there, that empties the recorder and turns it on
(loading a reader anywhere else, as the manifest's tests do, leaves the
program's state alone), kept still while a torch.profiler session
records (`enable(in_sessions=False)`), so the profiled slice holds what it
holds with the recorder off, and the recorder covers the set-up's short
run and the rest of the window.  Where the program has no recorder (a tree
from before it), `arm()` does nothing and every reader returns None.

A span open when the slice's session started or stopped (marked
`profiled`) is left out of every time: the profiler's start and stop lie
inside it.  The medians of a span's time read only the spans that closed
before the recorder first stood still for a session (`still_from_ns`):
after a torch.profiler session over the card the host runs the same steps
slower (1.5-1.8x a B = 1 step, PERF.md), so they read the set-up's run and
the steps of the first run before its profiled slice (the warm-up solve
before the MAP cell's profiled one).  Each function returns None where it
finds nothing to read, never 0.
"""
from __future__ import annotations

import statistics
import sys

_ARMED = []   # the recorder's module, once arm() has turned it on


def _recorder():
    """The program's profiling module where it has the recorder, else None."""
    try:
        from semiblind_tv_tpu_torch.runtime import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, n) for n in ("enable", "reset", "snapshot")):
        return None
    return profiling


def _under_run() -> bool:
    """Whether harness.run is on the stack: a traced run loading its readers."""
    from portbench import harness

    f = sys._getframe(1)
    while f is not None:
        if f.f_code is harness.run.__code__:
            return True
        f = f.f_back
    return False


def arm() -> None:
    """Empty the program's recorder and turn it on, once a process, when a
    traced run (harness.run) loads the reader that calls it."""
    if _ARMED or not _under_run():
        return
    profiling = _recorder()
    if profiling is not None:
        profiling.reset()
        profiling.enable(in_sessions=False)
        _ARMED.append(profiling)


def snapshot():
    """The recorder's snapshot() since arm(), or None."""
    return _ARMED[0].snapshot() if _ARMED else None


def _ms(s):
    return (s["end_ns"] - s["start_ns"]) / 1e6


def median_ms(name, snap=None):
    """Median ms of the `name` spans closed before the first profiler
    session (all of them where there was none)."""
    snap = snapshot() if snap is None else snap
    if snap is None:
        return None
    cut = snap.get("still_from_ns")
    times = [_ms(s) for s in snap["spans"] if s["name"] == name and not s["profiled"]
             and (cut is None or s["end_ns"] < cut)]
    return statistics.median(times) if times else None


def run_gap_ms(snap=None):
    """Median over the runs of a `sapg.run` span's ms outside its
    `sapg.warmup` and `sapg.segment` children: the prologue, the
    assembly and what lies between the phases.  Only the runs with the
    most main iterations count (not the set-up's short run), those after
    the profiled slice too: no full run precedes it."""
    snap = snapshot() if snap is None else snap
    if snap is None:
        return None
    runs = {s["id"]: s for s in snap["spans"] if s["name"] == "sapg.run"}
    inside = {r: 0.0 for r in runs}
    segment_run = {}
    for s in snap["spans"]:
        if s["parent"] in runs and s["name"] in ("sapg.warmup", "sapg.segment"):
            inside[s["parent"]] += _ms(s)
            if s["name"] == "sapg.segment":
                segment_run[s["id"]] = s["parent"]
    steps = {r: 0 for r in runs}
    for s in snap["spans"]:
        if s["name"] == "sapg.step" and s["parent"] in segment_run:
            steps[segment_run[s["parent"]]] += 1
    if not runs:
        return None
    most = max(steps.values())
    return statistics.median(_ms(runs[r]) - inside[r] for r in runs if steps[r] == most)


def sweeps_per_call(kernel, snap=None):
    """Sweeps a chain's prox ran a call of `kernel`: sweeps.<kernel> over
    chain_calls.<kernel>, over the set-up and the whole window."""
    snap = snapshot() if snap is None else snap
    if snap is None or not snap["counters"].get("chain_calls." + kernel):
        return None
    return snap["counters"].get("sweeps." + kernel, 0) / snap["counters"]["chain_calls." + kernel]
