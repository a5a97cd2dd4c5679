"""What a torch.profiler session's `user_annotation` events say: the
program's spans (semiblind_tv_tpu_torch/runtime/profiling.py, recorded with
`enable()` while a session records) read beside `profile.read`'s Trace, and
each idle gap of the device named by the innermost span at its middle.
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile

from portbench import profile


class _Saved:
    """A finished session's Chrome trace, saved once, handed to profile.read."""

    def __init__(self, path):
        self.path = path

    def export_chrome_trace(self, path):
        shutil.copyfile(self.path, path)


def read_with_spans(prof):
    """(profile.read's Trace, [(name, start µs, end µs)] of the
    user_annotation events) of a finished session: a session's trace can
    be exported once."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = profile.read(_Saved(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return trace, [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and "dur" in e]


def idle_spans(trace, spans):
    """{span name: idle seconds}: each idle gap of the trace's device named
    by the innermost span running at its middle ("no span" where none)."""
    busy = trace.busy()
    edges = [trace.start] + [x for iv in busy for x in iv] + [trace.end]
    spans = sorted(spans, key=lambda r: r[1])
    starts = [s for _, s, _ in spans]
    total = {}
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        label, best = "no span", None
        for n, a, b in spans[:bisect.bisect_right(starts, mid)]:
            if b >= mid and (best is None or b - a < best):
                label, best = n, b - a
        total[label] = total.get(label, 0.0) + (e - s) * 1e-6
    return total
