"""The benchmark's harness: finds a cell's pieces by name, runs it, judges it
and prints the result.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name `BENCHMARK.json`
gives it:

    portbench/configs/<config>.json     the configuration (`file` in BENCHMARK.json)
    portbench/traffic/<traffic>.json    the mix; its `driver` names
    portbench/drivers/<driver>.py       the window driver (class Driver)
    portbench/cells/<workload>.json     how `correct` compares: each number's limit
    portbench/metrics/<metric>.py       a per-layer metric's reader (UNIT, LAYER,
                                        MOVES, read(reading) -> number or None)
    portbench/held/<workload>.json      a cell held back from BENCHMARK.json: its
                                        entries, run by the tests and the control

A run: set-up (the window driver builds the program's problem from the seed and
warms up the cell's shapes), the window (`--seconds` of the cell's work,
ending with the last unit of work started before the deadline), the peak
memory, the program's state freed, then the reference's check of a sample
of what the window produced.  `--trace 1` runs the same, with a profiler
over a slice of the window, and reports the per-layer metrics instead of
the end-to-end ones.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "semiblind_tv_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    seed: int
    device: str


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root=ROOT, held=False) -> dict:
    """BENCHMARK.json; with `held`, also the cells held back from it
    (portbench/held/<cell>.json: the entries a later PR would add to
    BENCHMARK.json to measure the cell), for the tests and the control."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    if held:
        folder = os.path.join(root, "portbench", "held")
        for name in sorted(os.listdir(folder)):
            extra = _load_json(os.path.join(folder, name))
            for key in ("workloads", "end_to_end", "per_layer"):
                bench[key] = bench[key] + extra[key]
    return bench


def entry(items, name):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no entry named {name!r}")


def load_module(path, name):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(bench, workload, seed, device, root=ROOT) -> Cell:
    w = entry(bench["workloads"], workload)
    c = entry(bench["configs"], w["config"])
    return Cell(
        name=workload, chips=w["chips"], config=_load_json(os.path.join(root, c["file"])),
        traffic=_load_json(os.path.join(root, "portbench", "traffic", w["traffic"] + ".json")),
        check=_load_json(os.path.join(root, "portbench", "cells", workload + ".json")),
        seed=seed, device=device)


def driver(c: Cell, root=ROOT):
    name = c.traffic["driver"]
    return load_module(os.path.join(root, "portbench", "drivers", name + ".py"),
                       f"portbench_driver_{name}").Driver(c)


def end_to_end(bench, workload):
    return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer(bench, workload):
    """The per-layer metrics a cell reports: those that list it under
    `workloads` (every per-layer entry lists its cells)."""
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def reader(metric, root=ROOT):
    """A per-layer metric's reader, checked against its entry."""
    mod = load_module(os.path.join(root, "portbench", "metrics", metric["name"] + ".py"),
                      "portbench_metric_" + metric["name"].replace(".", "_").replace("-", "_"))
    for key, attr in (("unit", "UNIT"), ("layer", "LAYER"), ("moves", "MOVES")):
        if getattr(mod, attr) != metric[key]:
            raise ValueError(f"{metric['name']}: {attr} {getattr(mod, attr)!r} in its file, "
                             f"{metric[key]!r} in BENCHMARK.json")
    return mod


def forbidden_loaded(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"


def judge(checks, failed):
    """correct: nothing failed and every number compared is at most its limit."""
    return failed == 0 and all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def run(workload, seed, seconds, trace, device="cuda", root=ROOT, t_start=None, log=None):
    """One run of a cell: the result's dict (the contract's last line)."""
    import torch

    log = log or sys.stderr
    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest(root)
    c = cell(bench, workload, seed, device, root)
    e2e, layers = end_to_end(bench, workload), per_layer(bench, workload)
    readers = {m["name"]: reader(m, root) for m in layers} if trace else {}
    on_card = torch.device(device).type == "cuda"
    torch.set_num_threads(1)  # one process, one host thread: the host-bound rates spread less
    drv = driver(c, root)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    win = drv.window(seconds, trace)
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(c.chips)) if on_card else 0
    drv.release()
    t_check = time.perf_counter()
    checks = drv.check()
    t_check = time.perf_counter() - t_check
    correct = judge(checks, win["failed"])

    if trace:
        reading = drv.reading()
        metrics = {}
        for m in layers:
            v = readers[m["name"]].read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics}
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    result["device"] = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                        "count": c.chips, "memory_peak_bytes": peak,
                        "power_limit": power_limit() if on_card else "none"}
    if trace:
        tr = reading["trace"]
        if tr is not None:
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    units = win["unit_s"] or [float("nan")]
    print(f"{workload} seed {seed}: {json.dumps(metrics)}; device {result['device']}; "
          f"{win['attempted']} attempted in the window, a unit's seconds min "
          f"{min(units):.4f} median {statistics.median(units):.4f} max {max(units):.4f}; "
          f"the check took {t_check:.1f} s; units {[round(u, 3) for u in win['unit_s']]}", file=log)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=log)
    return result


def main(argv=None, t_start=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = entry(manifest()["workloads"], args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the configurations run float32 with TF32 off, as the port's CLI sets it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
