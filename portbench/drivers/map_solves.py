"""Window driver `map_solves`: SALSA MAP solves, back to back.

Each solve is the program's `salsa_tv` on the configuration's observation y
and true OTF, at θ = the traffic's `theta`, τ = θ·σ² (σ² the observation's
own), µ = mu_factor·θ, the configuration's `tv_iters` warm Chambolle sweeps
and `outer_iters` outer iterations at tol `tol` (0: the stop never fires,
so every solve does the same work).  No solve starts after the deadline.
The traffic's `metric` (`map_solve_s`) = the window's wall time / the
solves completed.  `--trace 1`
profiles one whole solve (after one solve unprofiled) at the window's
start.

`correct` compares the x of one solve drawn from the seed with the
reference's solve on the same image and observation noise.
"""
from __future__ import annotations

import random
import time

import numpy as np

from portbench import compare, inputs, port
from portbench.profile import profiled
from portbench.reference import problem as refproblem
from portbench.reference import salsa as refsalsa
from portbench.reference.precision import exact


def reference_solve(c, q=exact):
    """The reference's x for cell c's solve, and its mean sweeps a prox call."""
    import torch

    demo, t = c.config["demo"], c.traffic
    img = inputs.image(c.config["image"])
    obs = inputs.normal_field(inputs.derive(c.seed, "observation"), img.shape, c.device)
    prob = refproblem.build(img, demo, obs)
    with torch.no_grad():
        x, sweeps = refsalsa.solve(
            prob["y"], prob["H"], tau=t["theta"] * prob["sigma"] ** 2,
            mu=t["theta"] * demo["salsa"]["mu_factor"], iters=t["outer_iters"],
            tv_iters=demo["salsa"]["tv_iters"], chambolle_tau=demo["chambolle_tau"],
            chambolle_tol=demo["chambolle_tol"], q=q)
    return x.cpu().double().numpy(), sweeps


def judged(c, x, x_ref):
    """[(name, gap, limit)] of a solve's x against the reference's."""
    return [("x_gap", compare.field_gap(x, x_ref), c.check["limits"]["x"])]


class Driver:
    def __init__(self, cell):
        self.c = cell
        self.xs, self.trace, self.sweeps = [], None, None

    def _sync(self):
        import torch

        if torch.device(self.c.device).type == "cuda":
            torch.cuda.synchronize()

    def setup(self):
        from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv

        c, t = self.c, self.c.traffic
        demo = c.config["demo"]
        cfg = port.demo_config(c.config)
        img = inputs.image(c.config["image"])
        obs = inputs.normal_field(inputs.derive(c.seed, "observation"), img.shape, c.device)
        p = port.build_problem(cfg, img, obs, c.device)
        kw = dict(tau=t["theta"] * float(p.sigma_true) ** 2, mu=t["theta"] * cfg.salsa.mu_factor,
                  blur=p.blur, tol=t["tol"], tv_iters=cfg.salsa.tv_iters,
                  chambolle_tau=demo["chambolle_tau"], chambolle_tol=demo["chambolle_tol"])
        self.solve = lambda iters: salsa_tv(p.y, p.H_true, max_iter=iters, **kw)
        self.solve(2)  # the cell's shapes, through the same entry
        self._sync()

    def window(self, seconds, trace):
        iters = self.c.traffic["outer_iters"]
        failed, self.solve_s = 0, []

        def one():
            nonlocal failed
            x = self.solve(iters).x
            failed += not np.all(np.isfinite(x))
            self.xs.append(x)

        t0 = time.perf_counter()
        deadline = t0 + seconds
        if trace:
            self.trace = profiled(self._sync, one, 1)
        while not self.xs or time.perf_counter() < deadline:
            t = time.perf_counter()
            one()
            self.solve_s.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
        return {"metrics": {self.c.traffic["metric"]: wall / len(self.xs)},
                "attempted": len(self.xs),
                "failed": failed, "unit_s": self.solve_s}

    def release(self):
        import torch

        self.solve = None
        if torch.device(self.c.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        idx = random.Random(inputs.derive(self.c.seed, "sample")).randrange(len(self.xs))
        x_ref, self.sweeps = self.ref = reference_solve(self.c)
        return judged(self.c, self.xs[idx], x_ref)

    def reading(self):
        """What the per-layer readers read (portbench/metrics)."""
        return {"kind": "map", "trace": self.trace, "iterations": self.c.traffic["outer_iters"],
                "chains": 1, "shape": self.xs[0].shape[-2:], "sweeps": self.sweeps}
