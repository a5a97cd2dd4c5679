"""Sharded SAPG: the full estimator on a ('data', 'chains') mesh (port of
`semiblind_tv_tpu/parallel/sapg_parallel.py`).

Layout (one process a rank, parallel/mesh.rank_layout):

  X / Xhat / prox : (D_l·C_l, M, N) on each rank, problem-major — the D_l
                    = D / data problems of the rank's data index, C_l =
                    chains_per_shard chains of each (chains index c holds
                    the problem's chains c·C_l … (c+1)·C_l − 1 of C = C_l·S)
  θ / σ² / PSF    : (D_l,) on each rank, replicated along 'chains'
  consts (yhat …) : (D_l, …)
  noise           : one source per problem; every rank of a problem's
                    chains group draws the problem's whole (C, M, N) field
                    (or (C, 2) seeds) each step and keeps its own rows

The JAX package vmaps the per-problem step over a rank's problems; here
the step is written batched (sapg/estimator.make_general_sapg_step), so
the rank's D_l·C_l chains go through ONE kernel launch a step with γ, λ,
λθ and σ² as per-chain vectors; each problem's sums run on the shapes of
its own run, so a problem's trajectory does not depend on the problems
beside it.  Per SAPG iteration the only traffic between ranks is one
all_reduce of the per-problem chain means of the SA statistics over the
'chains' group (lax.pmean), and the hyperparameter update is computed
alike on every rank of the group, so the trajectory does not depend on the
layout: the replicated per-problem noise makes `run_sapg(mesh=)`
run_sapg(n_chains=C)'s trajectory up to the order of the cross-chain sums.

The entries here read the rank's layout from the mesh and hand it to the
estimator's run loop (sapg/estimator.run_sapg_layout), which runs one
device's runs too.  `run_sapg_sharded` is the complete pipeline
(SAPG_algorithm_Guassian.m:67-306): warm-up, main scan with the full trace
bundle, per-problem EB extraction through `assemble_result`, posterior
moments, mid-run checkpoint/resume and the NaN guard; it returns one
SAPGResult per problem, on every rank (the chains' final states gathered
over 'chains', the problems over 'data').  On a card it replays the
iterations as CUDA graphs cut at the step's all_reduce, which runs eagerly
between them (estimator._GraphIterations).  `run_sapg_sharded_steps` is
the bare stepper (no warm-up, eager) for throughput runs.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from semiblind_tv_tpu_torch.parallel.mesh import rank_layout
from semiblind_tv_tpu_torch.runtime.problem import Problem
from semiblind_tv_tpu_torch.sapg.estimator import SAPGResult, SAPGRun, run_sapg_layout

__all__ = [
    "run_sapg_sharded",
    "run_sapg_sharded_steps",
]


def run_sapg_sharded(
    problems: Sequence[Problem],
    mesh,
    generators=None,
    chains_per_shard: int = 1,
    x0=None,
    noise: Optional[Sequence[Callable]] = None,
    seeds: Optional[Sequence[Callable]] = None,
    route: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_backend: str = "npz",
    fault_hook=None,
    nan_guard: bool = True,
    max_restores: int = 1,
    _graphs: bool = True,
) -> List[SAPGResult]:
    """The complete pipeline on a ('data', 'chains') mesh; every rank of the
    mesh calls it with the same arguments.  All problems share image shape,
    PSF family and config (independent instances: the demo script's
    `for i_im` loop, run_Gaussian_demo.m:100) and lie on this rank's device.

    generators: one torch.Generator per problem on the rank's device (or one
    generator for one problem); noise/seeds: instead, one source per
    problem, asked for the problem's whole field — noise[d]((C, M, N)) or
    seeds[d](C) — once per warm-up and main step.  Returns one SAPGResult
    per problem, equal in content to run_sapg(problem, n_chains=C) with the
    same source up to the order of the cross-chain sums.

    checkpoint_every/checkpoint_path: segments, saves and resumes as
    run_sapg does; a world of one process writes npz (or the directory
    backend, "orbax"), a larger world must take "orbax", every rank writing
    its own arrays.  The generator states ride along.  fault_hook(seg_idx,
    carry) gets the rank's carry (X, Xhat, prox, θ, σ², params[, extra]);
    where the iterations replay as CUDA graphs that carry is the graphs'
    buffers, valid until the next iteration.  _graphs=False runs the step
    eagerly where the graphs would engage (for tests)."""
    return run_sapg_layout(
        problems, rank_layout(mesh, len(problems), chains_per_shard), generators, x0=x0,
        noise=noise, seeds=seeds, route=route, checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path, checkpoint_backend=checkpoint_backend,
        fault_hook=fault_hook, nan_guard=nan_guard, max_restores=max_restores,
        _graphs=_graphs,
    )


def run_sapg_sharded_steps(problems, mesh, generators, chains_per_shard=1, n_steps=100,
                           route=None):
    """Bare stepper: n_steps sharded SAPG iterations from a warm start at y,
    no warm-up phase.  Returns (state, θ traces (D, n_steps)) with state =
    dict(X = the rank's (D_l·C_l, M, N) chains, theta and sigma2 of every
    problem (D,), n_chains = C)."""
    run = SAPGRun(problems, rank_layout(mesh, len(problems), chains_per_shard), route=route,
                  warmup=1, samples=n_steps + 1)
    draw, _ = run.draws(generators)
    carry, _, _ = run.warm(run.start(run.init_x()), draw)
    carry, traces = run.scan(carry, range(2, n_steps + 2), draw)
    per_problem = run.gather_data(
        [(traces["theta"][:, i], float(carry[4][i])) for i in range(len(run.layout.problems))])
    state = dict(X=carry[0], theta=np.array([t[-1] for t, _ in per_problem]),
                 sigma2=np.array([s for _, s in per_problem]), n_chains=run.n_chains)
    return state, np.stack([t for t, _ in per_problem])
