"""Tracing / profiling / observability utilities (port of
`semiblind_tv_tpu/runtime/profiling.py`, with the port's own spans and
counters).

The reference's tracing is tic/toc wall-clock, cputime arrays, and a global
operator-call counter (SURVEY §5: run_Gaussian_demo.m:198-201,
SALSA/callcounter.m:8-16).  Here:

  * `span(name)`      — a named region of the program (`with span("sapg.step"):`),
                        recorded in memory while the recorder is on
                        (`enable()`); off, the default, it returns one shared
                        no-op object after a flag check.  On, each span is kept
                        as (name, id, parent id, start, end, time in its
                        children, profiled: a session recorded as it opened
                        or closed) in nanoseconds of one monotonic clock
                        (time.perf_counter_ns), the parent being the span
                        open around it; and while a torch.profiler session is
                        recording, the span also enters
                        torch.profiler.record_function(name), so it sits in
                        the session's Chrome trace as a `user_annotation` event
                        on the kernels' clock.  At most MAX_SPANS are kept;
                        past that only per-name totals (`spans.dropped`
                        counts them).  `enable(in_sessions=False)` keeps
                        the recorder still while a session records: it opens
                        no span and counts no sweep then, so the session
                        sees the program as with the recorder off.
                        `snapshot()` returns what was kept, `export(path)`
                        writes it as a Chrome trace.
  * `counters`        — one registry of named integer counters.  The kernel
                        wrappers' launch counts (`launches.<kernel>`) and
                        the resident kernels' chain groups run one after
                        another (`groups.<kernel>`, A-E and J) are always
                        on.  While the recorder is on, every wrapper
                        whose kernel writes its per-chain sweep counts hands
                        them to `count_sweeps(kernel, iters)`, which adds the
                        calls' chains to `chain_calls.<kernel>` and keeps the
                        device tensor (no launch, no sync); `fold_sweeps()`
                        adds the kept counts to `sweeps.<kernel>`, once a run,
                        after its synchronize.  Inside a CUDA graph's capture
                        (`capturing()`) the launch and group counts and the
                        sweep-count tensors are collected instead, and each
                        replay reports them (`replayed()`).  The SAPG run counts
                        `graph.captures`, `graph.replays` and
                        `graph.eager_steps` (iterations run without a
                        replay), always on.  Only across ranks (a chains
                        group of more than one) the sharded run also counts,
                        always on, `collective.all_reduce.calls` and
                        `.bytes` (sapg/estimator.py's problem_means, in the
                        span `sapg.allreduce`) and the noise elements each
                        rank draws and keeps, `noise.drawn`/`noise.kept`
                        (sapg/estimator.SAPGRun.draws), and records the spans
                        `sapg.gather` (the end-of-run gathers) and
                        `world.start` (runtime/distributed.start_world).
  * `trace(dir)`      — a torch.profiler region (CPU, and the card's kernels
                        when CUDA is available) whose Chrome trace is written
                        to `dir/trace.json` (view in Perfetto or
                        chrome://tracing); a span still open when it ends is
                        left out of the file, not cut at its end.
  * `CallCounter`     — wraps an operator callable and counts applications
                        (the reference's callcounter + `global calls`);
                        host-side by design — the solvers also report their
                        analytic op_counts.
  * `MetricsLogger`   — JSON-lines structured metrics writer, optionally teed
                        to TensorBoard.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["span", "counters", "Counters", "enable", "disable", "enabled", "reset", "snapshot",
           "export", "count_sweeps", "fold_sweeps", "capturing", "replayed", "trace",
           "CallCounter", "MetricsLogger", "TRACE_FILE", "MAX_SPANS"]

TRACE_FILE = "trace.json"
MAX_SPANS = 1 << 18     # spans kept in full; later ones only in their name's totals
MAX_KEPT_SWEEPS = 8192  # sweep-count tensors kept before an early fold


class Counters:
    """Named integer counters, 0 until first added to."""

    def __init__(self):
        self._values: Dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        self._values[name] = self._values.get(name, 0) + n

    def __getitem__(self, name: str) -> int:
        return self._values.get(name, 0)

    def reset(self, *names: str) -> None:
        """Zero the named counters, or every counter when none is named."""
        if not names:
            self._values.clear()
        for name in names:
            self._values.pop(name, None)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._values)


counters = Counters()


class _Recorder:
    """The spans kept so far and the recorder's switches."""

    def __init__(self):
        self.on = False
        self.in_sessions = True
        self.annotate_ready = False
        self.still_from = None  # when it first stood still for a session (ns)
        self.records = []      # (name, id, parent, start_ns, end_ns, child_ns, profiled)
        self.dropped = {}      # name -> [count, total_ns, self_ns] past MAX_SPANS
        self.kept_sweeps = []  # (kernel, device int32 tensor of sweep counts)
        self.capture = None    # the _Captured of a CUDA graph capture under way
        self.open = None       # the innermost open span
        self.next_id = 0


_REC = _Recorder()
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """The span of a recorder that is off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "start", "child_ns", "profiled", "rf")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self.profiled = profiled

    def __enter__(self):
        rec = _REC
        self.parent = rec.open
        rec.open = self
        self.id = rec.next_id
        rec.next_id += 1
        self.child_ns = 0
        self.rf = None
        if self.profiled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        rec = _REC
        rec.open = self.parent
        dur = end - self.start
        parent = -1
        if self.parent is not None:
            self.parent.child_ns += dur
            parent = self.parent.id
        if len(rec.records) < MAX_SPANS:
            rec.records.append((self.name, self.id, parent, self.start, end, self.child_ns,
                                self.profiled or _profiler_enabled()))
        else:
            tot = rec.dropped.setdefault(self.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.child_ns
            counters.add("spans.dropped")
        return False


def span(name: str):
    """A context manager that records the region it encloses as `name`
    while the recorder is on; off, or still inside a session, the shared
    no-op."""
    if not _REC.on:
        return _OFF
    profiled = _profiler_enabled()
    if profiled and not _REC.in_sessions:
        if _REC.still_from is None:
            _REC.still_from = time.perf_counter_ns()
        return _OFF
    return _Span(name, profiled)


def enable(in_sessions: bool = True) -> None:
    """Turn the recorder on.  in_sessions=False keeps it still while a
    torch.profiler session records (no span opens, no sweep is counted),
    so a session sees what it sees with the recorder off; a span open when
    the session starts or stops is kept, marked profiled.  With in_sessions,
    the process's first record_function (~2 ms of set-up) is paid here, not
    inside a span."""
    if in_sessions and not _REC.annotate_ready:
        with torch.profiler.record_function("semiblind.enable"):
            pass
        _REC.annotate_ready = True
    _REC.on = True
    _REC.in_sessions = in_sessions


def disable() -> None:
    """Turn the recorder off; what it kept stays until reset()."""
    _REC.on = False


def enabled() -> bool:
    return _REC.on


def reset() -> None:
    """Drop the kept spans, the totals, the kept sweep counts and every
    counter.  Spans open now still record when they close."""
    _REC.records = []
    _REC.dropped = {}
    _REC.kept_sweeps = []
    _REC.still_from = None
    counters.reset()


def count_sweeps(kernel: str, iters: torch.Tensor) -> None:
    """A prox call's per-chain sweep counts, from the kernel (or plain
    version) `kernel`: nothing while the recorder is off.  A CPU tensor is
    added to `sweeps.<kernel>` at once; a device tensor is kept, unread,
    until fold_sweeps()."""
    if _REC.capture is not None:
        _REC.capture.sweeps.append((kernel, iters))
        return
    if not _REC.on or (not _REC.in_sessions and _profiler_enabled()):
        return
    counters.add("chain_calls." + kernel, iters.numel())
    if iters.device.type == "cpu":
        counters.add("sweeps." + kernel, int(iters.sum()))
        return
    _REC.kept_sweeps.append((kernel, iters if iters.ndim == 1 else iters.reshape(-1)))
    if len(_REC.kept_sweeps) >= MAX_KEPT_SWEEPS:
        fold_sweeps()


class _Captured:
    """What the kernel wrappers reported while a CUDA graph was captured:
    `launches`, {counter: count} of the `launches.*` and `groups.*`
    counters, taken back out of `counters` (a capture runs nothing), and
    `sweeps`, the (kernel, sweep-count tensor) pairs, the tensors being the
    graph's own, which each replay rewrites."""

    def __init__(self):
        self.launches = {}
        self.sweeps = []


@contextlib.contextmanager
def capturing():
    """The region of a CUDA graph capture: yields a _Captured that collects
    the wrappers' launch and group counts and sweep-count tensors reported
    inside it, which leave `counters` and the recorder as they were.  Hand
    it to replayed() after each replay of the graph."""
    cap = _Captured()
    before = counters.snapshot()
    outer, _REC.capture = _REC.capture, cap
    try:
        yield cap
    finally:
        _REC.capture = outer
        for name, n in counters.snapshot().items():
            if name.startswith(("launches.", "groups.")) and n != before.get(name, 0):
                cap.launches[name] = n - before.get(name, 0)
                counters.add(name, -cap.launches[name])


def replayed(cap: "_Captured") -> None:
    """Report one replay of a captured graph: its launches and groups to
    `counters`, and, while the recorder counts sweeps, a copy of each
    sweep-count tensor it wrote to count_sweeps (one device copy each; the
    next replay overwrites the graph's own)."""
    for name, n in cap.launches.items():
        counters.add(name, n)
    if cap.sweeps and _REC.on and (_REC.in_sessions or not _profiler_enabled()):
        for kernel, iters in cap.sweeps:
            count_sweeps(kernel, iters.clone())


def fold_sweeps() -> None:
    """Add the kept device sweep counts to their `sweeps.<kernel>` counters:
    one concatenation and one host read a kernel, which wait for the device.
    Called where a run already waits (after its synchronize)."""
    kept, _REC.kept_sweeps = _REC.kept_sweeps, []
    by_kernel = {}
    for kernel, iters in kept:
        by_kernel.setdefault((kernel, iters.device), []).append(iters)
    for (kernel, _), parts in by_kernel.items():
        counters.add("sweeps." + kernel, int(torch.cat(parts).sum()))


def snapshot() -> dict:
    """What the recorder holds: `spans`, the kept records as dicts (times
    in ns); `totals`, {name: {count, total_ns, self_ns}} over every span,
    kept or dropped; `counters`, after folding the kept sweep counts;
    `still_from_ns`, when the recorder first stood still for a session
    (enable(in_sessions=False)), else None."""
    fold_sweeps()
    keys = ("name", "id", "parent", "start_ns", "end_ns", "child_ns", "profiled")
    spans = [dict(zip(keys, r)) for r in _REC.records]
    totals = {n: {"count": c, "total_ns": t, "self_ns": s} for n, (c, t, s) in _REC.dropped.items()}
    for s in spans:
        tot = totals.setdefault(s["name"], {"count": 0, "total_ns": 0, "self_ns": 0})
        dur = s["end_ns"] - s["start_ns"]
        tot["count"] += 1
        tot["total_ns"] += dur
        tot["self_ns"] += dur - s["child_ns"]
    return {"spans": spans, "totals": totals, "counters": counters.snapshot(),
            "still_from_ns": _REC.still_from}


def export(path: str) -> dict:
    """Write snapshot() as a Chrome trace (Perfetto, chrome://tracing): one
    complete event a kept span, in µs of the recorder's clock, and the
    counters as one counter event at the end.  Returns the snapshot."""
    snap = snapshot()
    pid = os.getpid()
    events = [{"name": s["name"], "cat": "span", "ph": "X", "pid": pid, "tid": 0,
               "ts": s["start_ns"] / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
               "args": {"id": s["id"], "parent": s["parent"], "profiled": s["profiled"]}}
              for s in snap["spans"]]
    end = max((s["end_ns"] for s in snap["spans"]), default=time.perf_counter_ns())
    events.append({"name": "counters", "ph": "C", "pid": pid, "tid": 0, "ts": end / 1e3,
                   "args": snap["counters"]})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"totals": snap["totals"]}}, f)
    return snap


def _open_annotated():
    """Names of the open spans that entered record_function, innermost first."""
    out, s = [], _REC.open
    while s is not None:
        if s.rf is not None:
            out.append(s.name)
        s = s.parent
    return out


def _drop_cut_spans(path: str, names) -> None:
    """Remove from the Chrome trace at `path` the user_annotation events of
    the spans still open when its session stopped: for each such name, its
    events that end last (the session cut them at its stop)."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"]
    drop = set()
    for name in set(names):
        mine = [i for i, e in enumerate(events)
                if e.get("cat") == "user_annotation" and e.get("name") == name and "dur" in e]
        mine.sort(key=lambda i: float(events[i]["ts"]) + float(events[i]["dur"]))
        drop.update(mine[len(mine) - names.count(name):])
    data["traceEvents"] = [e for i, e in enumerate(events) if i not in drop]
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: with profiling.trace('/tmp/trace') as prof: run_step().

    Yields the torch.profiler.profile object (its key_averages() give the
    per-kernel times); on exit the Chrome trace is written to
    `log_dir/trace.json`, without the spans still open then (a span is in
    the file whole or not at all)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    cut = _open_annotated()
    if cut:
        _drop_cut_spans(path, cut)


class CallCounter:
    """Operator-apply counter (reference SALSA/callcounter.m semantics)."""

    def __init__(self, fn, name: str = "A", registry: Optional[Dict[str, int]] = None):
        self.fn = fn
        self.name = name
        self.registry = registry if registry is not None else {}
        self.registry.setdefault(name, 0)

    def __call__(self, *args, **kwargs):
        self.registry[self.name] += 1
        return self.fn(*args, **kwargs)

    @property
    def calls(self) -> int:
        return self.registry[self.name]


class MetricsLogger:
    """Append-only JSON-lines metrics stream, optionally teed to TensorBoard.

    With `tensorboard_dir` set, every float-valued metric is also written as
    a TensorBoard scalar (runtime/tensorboard.py — dependency-free tfevents
    encoder), so SAPG/solver traces can be watched live in TensorBoard."""

    def __init__(self, path: str, tensorboard_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")
        self._tb = None
        if tensorboard_dir is not None:
            from semiblind_tv_tpu_torch.runtime.tensorboard import TensorBoardWriter

            self._tb = TensorBoardWriter(tensorboard_dir)

    def log(self, step: int, **metrics: Any) -> None:
        rec = {"step": step}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
            if self._tb is not None and isinstance(rec[k], float):
                self._tb.add_scalar(k, rec[k], step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
