"""Tracing / profiling / observability utilities (port of
`semiblind_tv_tpu/runtime/profiling.py`).

The reference's tracing is tic/toc wall-clock, cputime arrays, and a global
operator-call counter (SURVEY §5: run_Gaussian_demo.m:198-201,
SALSA/callcounter.m:8-16).  Here:

  * `trace(dir)`      — a torch.profiler region (CPU, and the card's kernels
                        when CUDA is available) whose Chrome trace is written
                        to `dir/trace.json` (view in Perfetto or
                        chrome://tracing).
  * `StepTimer`       — wall-clock timing that synchronises the CUDA device of
                        every tensor in the timed result, running
                        mean/percentiles.
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

import numpy as np
import torch

__all__ = ["trace", "StepTimer", "CallCounter", "MetricsLogger", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: with profiling.trace('/tmp/trace') as prof: run_step().

    Yields the torch.profiler.profile object (its key_averages() give the
    per-kernel times); on exit the Chrome trace is written to
    `log_dir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _synchronize(result) -> None:
    """Wait for the CUDA devices holding the tensors of `result` (a tensor,
    or a list, tuple or dict of them)."""
    devices = set()

    def walk(v):
        if torch.is_tensor(v):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            for vv in v.values():
                walk(vv)
        elif isinstance(v, (list, tuple)):
            for vv in v:
                walk(vv)

    walk(result)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Wall-clock step timing with device synchronisation."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def time(self, result_holder=None):
        t0 = time.perf_counter()
        yield
        if result_holder is not None:
            _synchronize(result_holder)
        self.times.append(time.perf_counter() - t0)

    def timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize(out)
        self.times.append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return dict(
            count=len(a),
            mean_s=float(a.mean()),
            p50_s=float(np.percentile(a, 50)),
            p95_s=float(np.percentile(a, 95)),
            total_s=float(a.sum()),
        )


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
