"""Window driver `sapg_runs`: whole SAPG estimation runs, back to back.

Each run is the program's `run_sapg(problem, n_chains=B, noise=...)` at the
configuration's budget (warm-up and SAPG iterations), ending in its host
read of the traces and the chains; the next starts when it returns, and no
run starts after the deadline.  Run r draws its Langevin noise from the
seed's r-th stream, so the reference can replay any run.
The rate, B · (warm-up + samples) · runs / the window's wall time, is
reported as the traffic's `metric` (`chain_iter_per_s`, or
`chain_iter_per_s.b16` where the card, not the host, sets the pace and the
rate spreads far less).

Traffic keys: `metric`, `n_chains`, and `trace_from`/`trace_steps`, the SAPG
iterations of the first run that `--trace 1` profiles.

`correct` compares, for one run drawn from the seed, the θ, σ² and free
PSF-parameter traces and the chains' last state with the reference's run
on the same image, observation noise and noise draws (`judged`).
"""
from __future__ import annotations

import dataclasses
import random
import time

import numpy as np

from portbench import compare, inputs, port
from portbench.profile import StepSlice
from portbench.reference import problem as refproblem
from portbench.reference import sapg as refsapg
from portbench.reference.precision import exact


def outputs(result, free):
    """What a run is judged by, from the program's SAPGResult."""
    out = {"theta": result.thetas[1:], "sigma2": result.sigma2s[1:], "X_last": result.X_last}
    out.update({n: result.psf_param_traces[n][1:] for n in free})
    return out


def judged(c, prog, ref):
    """[(name, gap, limit)] of a run against the reference's.  The traces
    are compared from ii = 2 on, or with the cell file's
    `traces_after_burn_in` over the iterations the EB estimates average
    (ii > burn_in): in the Moffat cell the SA's first ~150 iterations throw
    σ² between the ends of its box, so two float32 runs part there by
    rounding and rejoin long before the burn-in (PERF.md)."""
    demo, check = c.config["demo"], c.check
    start = demo["burn_in"] - 1 if check.get("traces_after_burn_in") else 0
    names = ["theta", "sigma2"] + [p["name"] for p in demo["psf_params"] if not p["fix"]]
    out = [(f"{n}_gap", compare.trace_gap(prog[n][start:], ref[n][start:]), check["limits"][n])
           for n in names]
    return out + [("x_last_gap", compare.field_gap(prog["X_last"], ref["X_last"]),
                   check["limits"]["x_last"])]


def reference_run(c, run_index, q=exact):
    """The reference's outputs for run `run_index` of cell c's window."""
    import torch

    demo = c.config["demo"]
    img = inputs.image(c.config["image"])
    obs = inputs.normal_field(inputs.derive(c.seed, "observation"), img.shape, c.device)
    prob = refproblem.build(img, demo, obs)
    draws = inputs.Draws(inputs.derive(c.seed, "chains", run_index), c.device)
    with torch.no_grad():
        return refsapg.run(prob, demo, c.traffic["n_chains"], draws, q=q)


class Driver:
    def __init__(self, cell):
        self.c = cell
        self.B = cell.traffic["n_chains"]
        self.free = [p["name"] for p in cell.config["demo"]["psf_params"] if not p["fix"]]
        self.runs, self.slice, self.sweeps = [], None, None

    def _sync(self):
        import torch

        if torch.device(self.c.device).type == "cuda":
            torch.cuda.synchronize()

    def setup(self):
        from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

        c = self.c
        self.run_sapg = run_sapg
        self.cfg = port.demo_config(c.config)
        img = inputs.image(c.config["image"])
        obs = inputs.normal_field(inputs.derive(c.seed, "observation"), img.shape, c.device)
        self.problem = port.build_problem(self.cfg, img, obs, c.device)
        # the cell's shapes, through the same entry: a run of three steps
        tiny = dataclasses.replace(self.cfg, sapg=dataclasses.replace(
            self.cfg.sapg, samples=3, warmup=3, burn_in=2))
        run_sapg(dataclasses.replace(self.problem, cfg=tiny), n_chains=self.B,
                 noise=inputs.Draws(inputs.derive(c.seed, "warm-up"), c.device))
        self._sync()

    def window(self, seconds, trace):
        c, sapg = self.c, self.cfg.sapg
        if trace:
            self.slice = StepSlice(self._sync, sapg.warmup - 1 + c.traffic["trace_from"],
                                   c.traffic["trace_steps"])
        failed, self.run_s = 0, []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while not self.runs or time.perf_counter() < deadline:
            r = len(self.runs)
            hook = self.slice.tick if self.slice is not None and r == 0 else None
            draws = inputs.Draws(inputs.derive(c.seed, "chains", r), c.device, hook=hook)
            t = time.perf_counter()
            out = outputs(self.run_sapg(self.problem, n_chains=self.B, noise=draws), self.free)
            self.run_s.append(time.perf_counter() - t)
            failed += not all(np.all(np.isfinite(v)) for v in out.values())
            self.runs.append(out)
        wall = time.perf_counter() - t0
        if self.slice is not None:
            self.slice.close()
        iters = self.B * (sapg.warmup + sapg.samples) * len(self.runs)
        return {"metrics": {c.traffic["metric"]: iters / wall}, "attempted": len(self.runs),
                "failed": failed, "unit_s": self.run_s}

    def release(self):
        import torch

        self.problem = self.run_sapg = None
        if torch.device(self.c.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        idx = random.Random(inputs.derive(self.c.seed, "sample")).randrange(len(self.runs))
        self.ref = ref = reference_run(self.c, idx)
        self.sweeps = ref["sweeps"]
        return judged(self.c, self.runs[idx], ref)

    def reading(self):
        """What the per-layer readers read (portbench/metrics)."""
        return {"kind": "sapg", "trace": self.slice.trace if self.slice else None,
                "iterations": self.c.traffic["trace_steps"], "chains": self.B,
                "shape": self.runs[0]["X_last"].shape[-2:], "sweeps": self.sweeps}
