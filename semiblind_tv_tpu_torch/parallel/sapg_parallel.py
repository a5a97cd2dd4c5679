"""Sharded SAPG: the full estimator on a ('data', 'chains') mesh (port of
`semiblind_tv_tpu/parallel/sapg_parallel.py`).

Layout (one process a rank, parallel/mesh.py):

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
the step is written batched (sapg/estimator.make_general_sapg_step with
problems=D_l), so the rank's D_l·C_l chains go through ONE kernel launch a
step with γ, λ, λθ and σ² as per-chain vectors; each problem's sums run
on the shapes of its own run, so a problem's trajectory does not depend on
the problems beside it.  Per SAPG iteration the
only traffic between ranks is one all_reduce of the per-problem chain
means of the SA statistics over the 'chains' group (lax.pmean), and the
hyperparameter update is computed alike on every rank of the group, so the
trajectory does not depend on the layout: the replicated per-problem noise
makes `run_sapg(mesh=)` run_sapg(n_chains=C)'s trajectory up to the order
of the cross-chain sums.

`run_sapg_sharded` is the complete pipeline (SAPG_algorithm_Guassian.m:
67-306): warm-up, main scan with the full trace bundle, per-problem EB
extraction through `assemble_result`, posterior moments, mid-run
checkpoint/resume and the NaN guard through `run_segmented_scan`; it
returns one SAPGResult per problem, on every rank (the chains' final
states gathered over 'chains', the problems over 'data').
`run_sapg_sharded_steps` is the bare stepper (no warm-up) for throughput
runs.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from semiblind_tv_tpu_torch.parallel.mesh import (
    CHAINS_AXIS,
    DATA_AXIS,
    axis_size,
    mesh_device,
)
from semiblind_tv_tpu_torch.runtime.checkpoint import (
    load_checkpoint_arrays,
    save_checkpoint_arrays,
)
from semiblind_tv_tpu_torch.runtime.problem import Problem
from semiblind_tv_tpu_torch.sapg.estimator import (
    SAPGResult,
    _host,
    _merge_traces,
    assemble_result,
    generator_noise,
    generator_seeds,
    make_general_sapg_step,
    problem_consts,
    run_segmented_scan,
)

__all__ = [
    "stack_problem_consts",
    "build_sharded_sapg",
    "run_sapg_sharded",
    "run_sapg_sharded_steps",
]


def stack_problem_consts(problems: Sequence[Problem]) -> dict:
    """Per-problem constants stacked along a leading problem axis."""
    consts = [problem_consts(p) for p in problems]
    return {k: torch.stack([torch.as_tensor(c[k]) for c in consts]) for k in consts[0]}


def build_sharded_sapg(
    problems: Sequence[Problem],
    mesh,
    chains_per_shard: int = 1,
    warmup: Optional[int] = None,
    route: Optional[str] = None,
) -> dict:
    """The rank's share of a sharded run: its problems and chains, the
    batched step and the warm-up and main-scan drivers.

    All problems share image shape, PSF family and config (independent
    instances: the driver's `for i_im` loop, run_Gaussian_demo.m:100) and
    lie on this rank's device.  `warmup` overrides cfg.sapg.warmup (the
    bare stepper passes 1: no warm-up iterations).

    Returns a dict: warm(X0, draw) -> (carry, logpi_wu (n_warm, D_l),
    logpi0 (D_l,)); scan(carry, iis, draw) -> (carry, host traces of
    (T, D_l)); init_x(x0) -> X0; and local (the rank's problem indices),
    rows (its chains' slice of a problem's C), n_chains (C), n_warm,
    psf_names, consts, aux, group (the chains group, None for one rank),
    data_group."""
    p0 = problems[0]
    cfg = p0.cfg
    blur = p0.blur
    dtype = blur.dtype
    device = mesh_device(mesh)
    D = len(problems)
    Dm, S = axis_size(mesh, DATA_AXIS), axis_size(mesh, CHAINS_AXIS)
    if D % Dm != 0:
        raise ValueError(f"{D} problems not divisible over data axis {Dm}")
    for p in problems:
        if p.device != device:
            raise ValueError(f"problem on {p.device}, this rank's device is {device}")
    D_l, C_l = D // Dm, int(chains_per_shard)
    C = C_l * S
    di, ci = mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(CHAINS_AXIS)
    local = list(range(di * D_l, (di + 1) * D_l))
    group = mesh.get_group(CHAINS_AXIS) if S > 1 else None
    n_warm = max((cfg.sapg.warmup if warmup is None else warmup) - 1, 0)

    step, aux = make_general_sapg_step(
        p0.model, blur, cfg, sigma_fix=p0.sigma_spec().fix, route=route, problems=D_l,
        chains_group=group,
    )
    consts = stack_problem_consts([problems[d] for d in local])
    theta0 = torch.full((D_l,), cfg.theta.init, dtype=dtype, device=device)
    params0 = {k: torch.full((D_l,), v, dtype=dtype, device=device)
               for k, v in cfg.init_psf_params().items()}
    shape = tuple(blur.shape)

    def init_x(x0=None):
        """X0 (D_l·C_l, M, N): each problem's y (op.X0's default,
        SAPG_algorithm_Guassian.m:10-12), or x0 for every problem."""
        if x0 is None:
            ys = torch.stack([problems[d].y for d in local])
        else:
            ys = torch.as_tensor(x0, dtype=dtype, device=device).expand((D_l,) + shape)
        return ys[:, None].expand((D_l, C_l) + shape).reshape((D_l * C_l,) + shape).contiguous()

    def warm(X, draw):
        """Warm-up (SAPG_algorithm_Guassian.m:67-93) from X; the initial
        prox (A2 on the card) takes λθ₀ per problem, per chain."""
        prox = aux["prox_b"](X, (consts["lam"] * aux["theta0"]).repeat_interleave(C_l))[0]
        carry = (X, blur.rfft(X), prox)
        logpi_wu = torch.empty((n_warm, D_l), dtype=dtype, device=device)
        for t in range(n_warm):
            carry, logpi_wu[t] = aux["warm_step"](carry, consts, draw())
        X, Xhat, prox = carry
        # logPiTraceX(1): logPi at the warm-start sample with the init params
        logpi0 = aux["logpi_init"](Xhat, aux["tv_b"](X), consts)
        carry = (X, Xhat, prox, theta0, consts["sigma2_init"].clone(), dict(params0))
        if cfg.sapg.track_posterior_moments:
            carry += (dict(pm_mean=torch.zeros_like(X), pm_m2=torch.zeros_like(X),
                           pm_count=0.0),)
        return carry, logpi_wu, logpi0

    def scan(carry, iis, draw):
        """The main iterations iis; host traces {name: (T, D_l)}, read back
        once."""
        iis = list(iis)
        names, buf = None, None
        for t, ii in enumerate(iis):
            carry, tr = step(carry, ii, consts, draw())
            if buf is None:
                names = list(tr)
                buf = torch.empty((len(names), len(iis), D_l), dtype=dtype, device=device)
            buf[:, t] = torch.stack([tr[n] for n in names])
        if buf is None:
            return carry, {}
        host = buf.cpu().numpy()
        return carry, {n: host[i] for i, n in enumerate(names)}

    return dict(
        warm=warm, scan=scan, init_x=init_x, local=local, rows=slice(ci * C_l, (ci + 1) * C_l),
        n_chains=C, chains_per_shard=C_l, n_warm=n_warm, psf_names=aux["psf_names"],
        consts=consts, aux=aux, group=group, n_group=S,
        data_group=mesh.get_group(DATA_AXIS) if Dm > 1 else None, shape=shape,
        device=device, dtype=dtype,
    )


def _problem_sources(problems, generators, noise, seeds, built):
    """One draw() of the step's noise for the rank's chains: each local
    problem's whole field (or seeds) from its own source, its rows kept."""
    aux, local, rows, C = built["aux"], built["local"], built["rows"], built["n_chains"]
    B = len(local) * built["chains_per_shard"]
    shape = (C,) + built["shape"]
    gens = [generators] if isinstance(generators, torch.Generator) else list(generators or [])
    if gens and len(gens) != len(problems):
        raise ValueError(f"{len(gens)} generators for {len(problems)} problems")
    ikr = aux["in_kernel_rng"](B)
    user = seeds if ikr else noise
    sources, state_gens = [], []
    for d in local:
        if user is not None:
            src = user[d]
            sources.append((lambda s=src: s(C)) if ikr else (lambda s=src: s(shape)))
            continue
        g = gens[d] if gens else None
        if g is None:
            raise ValueError("run_sapg_sharded needs generators or a noise source")
        state_gens.append(g)
        src = (generator_seeds(g, built["device"]) if ikr
               else generator_noise(g, built["dtype"], built["device"]))
        sources.append((lambda s=src: s(C)) if ikr else (lambda s=src: s(shape)))
    whole = built["n_group"] == 1

    def draw():
        parts = [src() if whole else src()[rows] for src in sources]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    return draw, state_gens


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _save_state(path, carry, done, seg_traces, logpi_wu, logpi0, gens, backend):
    """Persist the rank's carry, the traces so far, the warm-up trace and
    its problems' generator states, keyed by rank (`rank<r>/`); Xhat as its
    real and imaginary planes (the estimator's _save_checkpoint)."""
    X, Xhat, prox, theta, sigma2, params = carry[:6]
    extra = carry[6] if len(carry) > 6 else {}
    arrays = {f"trace/{k}": v for k, v in _merge_traces(seg_traces).items()}
    arrays.update(X=_host(X), Xhat_re=_host(Xhat.real), Xhat_im=_host(Xhat.imag),
                  prox=_host(prox), theta=_host(theta), sigma2=_host(sigma2),
                  done_iters=np.asarray(done), logpi_wu=_host(logpi_wu), logpi0=_host(logpi0))
    for i, g in enumerate(gens):
        arrays[f"generator_state/{i}"] = g.get_state().numpy()
    for k, v in params.items():
        arrays[f"param/{k}"] = _host(v)
    for k, v in extra.items():
        arrays[f"extra/{k}"] = _host(v)
    pre = f"rank{_rank()}/"
    save_checkpoint_arrays(path, {pre + k: v for k, v in arrays.items()}, backend=backend)


def _restore_state(path, device, gens, backend):
    """Inverse of _save_state for this rank: (carry, done, [traces],
    logpi_wu, logpi0); the generator states are set on `gens`."""
    pre = f"rank{_rank()}/"
    z = {k[len(pre):]: v for k, v in
         load_checkpoint_arrays(path, backend=backend, prefix=pre).items()}

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    params = {k[len("param/"):]: t(z[k]) for k in z if k.startswith("param/")}
    traces = {k[len("trace/"):]: z[k] for k in z if k.startswith("trace/")}
    extra = {k[len("extra/"):]: float(z[k]) if z[k].ndim == 0 else t(z[k])
             for k in z if k.startswith("extra/")}
    for i, g in enumerate(gens):
        g.set_state(torch.from_numpy(z[f"generator_state/{i}"]))
    carry = (t(z["X"]), torch.complex(t(z["Xhat_re"]), t(z["Xhat_im"])), t(z["prox"]),
             t(z["theta"]), t(z["sigma2"]), params)
    if extra:
        carry += (extra,)
    return carry, int(z["done_iters"]), [traces], t(z["logpi_wu"]), t(z["logpi0"])


def _gather_chains(v: np.ndarray, built) -> np.ndarray:
    """(D_l·C_l, M, N) of this rank → (D_l, C, M, N), the chains of the
    group's ranks in chains order."""
    D_l, C_l = len(built["local"]), built["chains_per_shard"]
    if built["group"] is None:
        return v.reshape((D_l, C_l) + v.shape[1:])
    parts = [None] * built["n_group"]
    dist.all_gather_object(parts, v, group=built["group"])
    return np.concatenate([p.reshape((D_l, C_l) + v.shape[1:]) for p in parts], axis=1)


def _gather_data(items: list, built) -> list:
    """The per-problem items of every data index, in problem order."""
    if built["data_group"] is None:
        return items
    parts = [None] * dist.get_world_size(built["data_group"])
    dist.all_gather_object(parts, items, group=built["data_group"])
    return [x for p in parts for x in p]


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
) -> List[SAPGResult]:
    """The complete pipeline on a ('data', 'chains') mesh; every rank of the
    mesh calls it with the same arguments.

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
    carry) gets the rank's carry (X, Xhat, prox, θ, σ², params[, extra])."""
    if dist.is_initialized() and dist.get_world_size() > 1 and checkpoint_backend == "npz" \
            and checkpoint_path is not None:
        raise ValueError("a multi-process run checkpoints to a directory: "
                         "checkpoint_backend='orbax'")
    built = build_sharded_sapg(problems, mesh, chains_per_shard, route=route)
    cfg = problems[0].cfg
    device = built["device"]
    draw, gens = _problem_sources(problems, generators, noise, seeds, built)

    t0 = time.perf_counter()
    resume = checkpoint_path is not None and os.path.exists(checkpoint_path)
    logpi = {}
    if resume:
        carry = None   # restore_fn supplies it, with the warm-up trace
    else:
        carry, logpi["wu"], logpi["0"] = built["warm"](built["init_x"](x0), draw)

    def restore():
        carry, done, traces, logpi["wu"], logpi["0"] = _restore_state(
            checkpoint_path, device, gens, checkpoint_backend)
        return carry, done, traces

    def save(carry, done, seg_traces):
        _save_state(checkpoint_path, carry, done, seg_traces, logpi["wu"], logpi["0"], gens,
                    checkpoint_backend)

    carry, seg_traces = run_segmented_scan(
        lambda c, iis: built["scan"](c, iis, draw), carry, cfg.sapg.samples,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path, save_fn=save,
        restore_fn=restore, fault_hook=fault_hook, nan_guard=nan_guard,
        max_restores=max_restores,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    exec_time = time.perf_counter() - t0
    traces = _merge_traces(seg_traces) if seg_traces else {}

    logpi_wu, logpi0 = _host(logpi["wu"]), _host(logpi["0"])
    X_all = _gather_chains(_host(carry[0]), built)
    extra = carry[6] if len(carry) > 6 else {}
    moments = {k: _gather_chains(_host(v), built) for k, v in extra.items()
               if k != "pm_count"}
    results = []
    for i, d in enumerate(built["local"]):
        extra_d = {k: v[i] for k, v in moments.items()}
        if extra:
            extra_d["pm_count"] = extra["pm_count"]
        results.append(assemble_result(
            problems[d], built["psf_names"], {k: v[:, i] for k, v in traces.items()},
            logpi_wu[:, i] if built["n_warm"] > 0 else np.zeros(0), float(logpi0[i]),
            X_all[i], extra_d, exec_time,
        ))
    return _gather_data(results, built)


def run_sapg_sharded_steps(problems, mesh, generators, chains_per_shard=1, n_steps=100,
                           route=None):
    """Bare stepper: n_steps sharded SAPG iterations from a warm start at y,
    no warm-up phase.  Returns (state, θ traces (D, n_steps)) with state =
    dict(X = the rank's (D_l·C_l, M, N) chains, theta and sigma2 of every
    problem (D,), n_chains = C)."""
    built = build_sharded_sapg(problems, mesh, chains_per_shard, warmup=1, route=route)
    draw, _ = _problem_sources(problems, generators, None, None, built)
    carry, _, _ = built["warm"](built["init_x"](), draw)
    carry, traces = built["scan"](carry, range(2, n_steps + 2), draw)
    per_problem = _gather_data(
        [(traces["theta"][:, i], float(carry[4][i])) for i in range(len(built["local"]))], built)
    state = dict(X=carry[0], theta=np.array([t[-1] for t, _ in per_problem]),
                 sigma2=np.array([s for _, s in per_problem]), n_chains=built["n_chains"])
    return state, np.stack([t for t, _ in per_problem])
