"""Window driver `sapg_sharded_runs`: whole SAPG estimation runs of the
configuration's chains sharded over the host's cards, back to back.

Each run is the program's `run_sapg(problem, n_chains=B, mesh=..., noise=...)`
on a ('data', 'chains') mesh of the configuration's `mesh` shape, one rank a
card, ending in its host read of the traces and the chains gathered from
every rank.  Rank 0 is this process, the harness's, so the memory peak, the
profiled slice, the program's recorder and the check are where the harness
reads them; ranks 1 … are started through the program's own
`runtime/distributed.start_world` and run `rank_main`: the same set-up, then
the same run each time rank 0 orders one (one broadcast a run of the run's
index, −1 to stop: rank 0 alone decides, before the deadline, whether a run
starts).  Every rank draws run r's whole (B, M, N) noise field a step from
the seed's r-th stream and keeps its own chains' rows, so a run is
run_sapg(n_chains=B)'s up to the order of the sums over the chains, and
the reference replays it.  The rate, B · (warm-up + samples) · runs / the
window's wall time, is reported as the traffic's `metric`.

Traffic keys: those of sapg_runs (`metric`, `n_chains`, `trace_from`,
`trace_steps`: the slice is rank 0's).  Configuration key: `mesh`, {"data":
D, "chains": C}.  The program's entry points are resolved before any
process starts and the world's groups time out after TIMEOUT_S, so a tree
without them fails at once and a lost rank ends the run, not hangs it.

`correct` compares, as sapg_runs does, one run drawn from the seed with the
reference's run on the same inputs, the reference's chains in one block a
card (reference/sapg_blocks.py), after the world has ended.
"""
from __future__ import annotations

import dataclasses
import datetime
import random
import time

import numpy as np

from portbench import inputs, port
from portbench.drivers import sapg_runs
from portbench.profile import StepSlice
from portbench.reference import problem as refproblem
from portbench.reference import sapg_blocks
from portbench.reference.precision import exact

TIMEOUT_S = 120.0


def _on_card(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def _prepare(config, traffic, seed, device):
    """A rank's problem on its device, the mesh and the cell's shapes warmed
    up through the same entry (a run of three steps); every rank calls it,
    since the mesh and the run are collective.  Returns (problem, mesh)."""
    from semiblind_tv_tpu_torch.parallel.mesh import make_mesh
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    cfg = port.demo_config(config)
    img = inputs.image(config["image"])
    obs = inputs.normal_field(inputs.derive(seed, "observation"), img.shape, device)
    problem = port.build_problem(cfg, img, obs, device)
    mesh = make_mesh(config["mesh"]["data"], config["mesh"]["chains"],
                     device_type="cuda" if _on_card(device) else "cpu",
                     timeout=datetime.timedelta(seconds=TIMEOUT_S))
    tiny = dataclasses.replace(cfg, sapg=dataclasses.replace(
        cfg.sapg, samples=3, warmup=3, burn_in=2))
    run_sapg(dataclasses.replace(problem, cfg=tiny), n_chains=traffic["n_chains"], mesh=mesh,
             noise=inputs.Draws(inputs.derive(seed, "warm-up"), device))
    return problem, mesh


def _order(r: int, device) -> int:
    """Rank 0's r (a run's index, or −1: stop) on every rank: one broadcast."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([r], dtype=torch.int64, device=device)
    dist.broadcast(flag, src=0)
    return int(flag.item())


def rank_main(rank, config, traffic, seed, device):
    """Ranks 1 …: the set-up, then each run rank 0 orders, until it says stop."""
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    problem, mesh = _prepare(config, traffic, seed, device)
    _order(0, device)   # the set-up's last collective (Driver.setup)
    while (r := _order(0, device)) >= 0:
        run_sapg(problem, n_chains=traffic["n_chains"], mesh=mesh,
                 noise=inputs.Draws(inputs.derive(seed, "chains", r), device))


def reference_run(c, run_index, q=exact):
    """The reference's outputs for run `run_index` of cell c's window, its
    chains in one block a rank's card (on the CPU, as many blocks there)."""
    import torch

    demo = c.config["demo"]
    ranks = c.config["mesh"]["data"] * c.config["mesh"]["chains"]
    devices = [torch.device("cuda", k) for k in range(ranks)] if _on_card(c.device) \
        else ["cpu"] * ranks
    img = inputs.image(c.config["image"])
    obs = inputs.normal_field(inputs.derive(c.seed, "observation"), img.shape, devices[0])
    prob = refproblem.build(img, demo, obs)
    draws = inputs.Draws(inputs.derive(c.seed, "chains", run_index), devices[0])
    with torch.no_grad():
        return sapg_blocks.run(prob, demo, c.traffic["n_chains"], draws, devices, q=q)


class Driver:
    def __init__(self, cell):
        self.c = cell
        self.B = cell.traffic["n_chains"]
        self.ranks = cell.config["mesh"]["data"] * cell.config["mesh"]["chains"]
        self.free = [p["name"] for p in cell.config["demo"]["psf_params"] if not p["fix"]]
        self.runs, self.slice, self.sweeps, self.world = [], None, None, None

    def _sync(self):
        import torch

        if _on_card(self.c.device):
            torch.cuda.synchronize()

    def _ending_the_world_on_error(self, fn, *args):
        try:
            return fn(*args)
        except BaseException:
            if self.world is not None:
                self.world.abort()
            raise

    def setup(self):
        # every entry point of the program the ranks use, before a process
        # starts: a tree without them fails here, at once
        from semiblind_tv_tpu_torch import _build
        from semiblind_tv_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
        from semiblind_tv_tpu_torch.runtime.distributed import start_world
        from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

        from portbench.drivers import sapg_sharded_runs as by_name  # importable by the ranks

        c = self.c
        if _on_card(c.device):
            _build.load_library()   # the first build here, not raced by the ranks
        self.run_sapg = run_sapg
        self.world = start_world(by_name.rank_main, self.ranks,
                                 (c.config, c.traffic, c.seed, c.device),
                                 device_type="cuda" if _on_card(c.device) else "cpu",
                                 timeout=TIMEOUT_S)
        self.problem, self.mesh = self._ending_the_world_on_error(
            _prepare, c.config, c.traffic, c.seed, c.device)
        # the default group's communicator (NCCL makes one at a group's first
        # collective) is made here, not in the window's first run
        self._ending_the_world_on_error(_order, 0, c.device)
        self._sync()

    def window(self, seconds, trace):
        return self._ending_the_world_on_error(self._window, seconds, trace)

    def _window(self, seconds, trace):
        c, sapg = self.c, self.problem.cfg.sapg
        if trace:
            self.slice = StepSlice(self._sync, sapg.warmup - 1 + c.traffic["trace_from"],
                                   c.traffic["trace_steps"])
        failed, self.run_s = 0, []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while not self.runs or time.perf_counter() < deadline:
            r = len(self.runs)
            _order(r, c.device)
            hook = self.slice.tick if self.slice is not None and r == 0 else None
            draws = inputs.Draws(inputs.derive(c.seed, "chains", r), c.device, hook=hook)
            t = time.perf_counter()
            out = sapg_runs.outputs(self.run_sapg(self.problem, n_chains=self.B, mesh=self.mesh,
                                                  noise=draws), self.free)
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
        """Stop the ranks, end the world (joining them) and free the program's state."""
        import torch

        self._ending_the_world_on_error(_order, -1, self.c.device)
        self.world.close()
        self.problem = self.mesh = self.run_sapg = None
        if _on_card(self.c.device):
            torch.cuda.empty_cache()

    def check(self):
        idx = random.Random(inputs.derive(self.c.seed, "sample")).randrange(len(self.runs))
        self.ref = ref = reference_run(self.c, idx)
        self.sweeps = ref["block_sweeps"][0]
        return sapg_runs.judged(self.c, self.runs[idx], ref)

    def reading(self):
        """What the per-layer readers read (portbench/metrics): rank 0's slice,
        its chains and the sweeps a prox call ran over them (block 0's)."""
        return {"kind": "sapg", "trace": self.slice.trace if self.slice else None,
                "iterations": self.c.traffic["trace_steps"], "chains": self.B // self.ranks,
                "shape": self.runs[0]["X_last"].shape[-2:], "sweeps": self.sweeps}
