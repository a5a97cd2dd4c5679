"""torch.profiler sessions over part of the window, and what the benchmark
reads from their traces.

`profiled` is `chip_smoke.py::profiled` of commit
c8d401c3512c32400c85205db3b41830d3fef4be with its retake unchanged: now
and then torch.profiler returns a session without a single kernel although
the calls ran (a few in a thousand one-call sessions on an H100,
`semiblind_tv_tpu_torch/benchmarks/profiler_drops.py` counts them), so a
session that holds no kernel is taken again, up to PROFILE_TRIES times.
Three changes: a session also records the host (its operators and the CUDA
API calls), it is returned as a `Trace` read from its Chrome trace instead
of key_averages(), and where every try came back empty there is no trace
(the per-layer metrics read from it are then left out) instead of an error.
`StepSlice` takes the same retake over a slice
of consecutive steps of a longer loop.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile

PROFILE_TRIES = 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH = re.compile(r"^cu(da)?Launch")


def _session():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _short(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0][:120] or name[:120]


@dataclasses.dataclass
class Trace:
    """Intervals in µs: (name, start, end) of the device's operations, of
    the host's CUDA API calls and of the host's operators."""

    device: list
    api: list
    host: list

    @property
    def start(self) -> float:
        return min(e[1] for e in self.device + self.api + self.host)

    @property
    def end(self) -> float:
        return max(e[2] for e in self.device + self.api + self.host)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self):
        """The union of the device's operations, as sorted disjoint intervals."""
        merged = []
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def kernel_us(self, patterns) -> float:
        """Device µs of the kernels whose names match any of the regexes."""
        pats = [re.compile(p) for p in patterns]
        return sum(e - s for n, s, e in self.device if any(p.search(n) for p in pats))

    def launches(self) -> int:
        """CUDA launch calls the host made (runtime and driver API)."""
        return sum(1 for n, _, _ in self.api if LAUNCH.search(n))

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took most time."""
        total = {}
        for n, s, e in self.device:
            total[_short(n)] = total.get(_short(n), 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(total.items(), key=lambda r: -r[1])[:top]]

    def idle_gaps(self, top=10):
        """[[what the host was doing, seconds]] over the device's idle gaps:
        each gap is named by the innermost host operator running at its
        middle (else the CUDA API call, else "host")."""
        busy = self.busy()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        spans = [(n, s, e) for n, s, e in sorted(self.host + self.api, key=lambda r: r[1])]
        starts = [s for _, s, _ in spans]
        total = {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            label, best = "host", None
            last = bisect.bisect_right(starts, mid) - 1
            for i in range(last, max(-1, last - 400), -1):
                n, a, b = spans[i]
                if b >= mid and (best is None or b - a < best):
                    label, best = n, b - a
            total[label] = total.get(label, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(total.items(), key=lambda r: -r[1])[:top]]


def read(prof) -> Trace:
    """The Trace of a finished torch.profiler session (through its Chrome trace,
    written under TMPDIR and deleted)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {"device": [], "api": [], "host": []}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        key = "device" if cat in DEVICE_CATS else "api" if cat in API_CATS else \
            "host" if cat == "cpu_op" else None
        if key:
            ts = float(ev["ts"])
            out[key].append((ev.get("name", ""), ts, ts + float(ev["dur"])))
    return Trace(**out)


def profiled(sync, fn, calls):
    """The Trace of `calls` calls of fn, after one warm-up call; a session
    that holds no kernel is taken again, up to PROFILE_TRIES times, and
    after that there is none (None).  `sync()` waits for the device."""
    fn()
    sync()
    for _ in range(PROFILE_TRIES):
        with _session() as prof:
            for _ in range(calls):
                fn()
            sync()
        trace = read(prof)
        if trace.device:
            return trace
    return None


class StepSlice:
    """Traces `steps` consecutive steps of a loop from step `start` on:
    `tick(n)` is called before step n (from 0).  `sync()` waits for the
    device where the slice opens and closes.  A slice that holds no kernel is taken
    again over the steps that follow, up to PROFILE_TRIES times; `trace`
    holds the first that does."""

    def __init__(self, sync, start: int, steps: int):
        self.sync, self.start, self.steps = sync, start, steps
        self.prof, self.opened, self.tries, self.trace = None, None, 0, None

    def tick(self, n: int) -> None:
        if self.trace is not None or self.tries >= PROFILE_TRIES:
            return
        if self.prof is None and n >= self.start:
            self.sync()
            self.prof = _session()
            self.prof.start()
            self.opened = n
        elif self.prof is not None and n >= self.opened + self.steps:
            self.sync()
            self.prof.stop()
            trace, self.prof = read(self.prof), None
            self.tries += 1
            if trace.device:
                self.trace = trace

    def close(self) -> None:
        """Drop a slice the loop ended inside."""
        if self.prof is not None:
            self.prof.stop()
            self.prof = None
