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

On a card, where the rank's step meets estimator.resolve_graph_replay's
rule (route 'B' with kernel B, fft_mode 'fft', a noise field, no posterior
moments), run_sapg_sharded replays each warm-up and SAPG iteration as CUDA
graphs cut at the step's all_reduce, which runs eagerly between them
(_GraphIterations), and keeps them for the problems' next runs on the
mesh; so the host's only work a replayed iteration is the draw, the
launches and the collective's call, and every rank's card, not its host
loop, sets the pace the all_reduce couples them to.  The bare stepper runs
eagerly.
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
from semiblind_tv_tpu_torch.runtime import profiling
from semiblind_tv_tpu_torch.runtime.profiling import counters, fold_sweeps, span
from semiblind_tv_tpu_torch.sapg.estimator import (
    SAPGResult,
    _host,
    _merge_traces,
    _store,
    assemble_result,
    generator_noise,
    generator_seeds,
    make_general_sapg_step,
    problem_consts,
    resolve_graph_replay,
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
    samples: Optional[int] = None,
    graphs: bool = False,
) -> dict:
    """The rank's share of a sharded run: its problems and chains, the
    batched step and the warm-up and main-scan drivers.

    All problems share image shape, PSF family and config (independent
    instances: the driver's `for i_im` loop, run_Gaussian_demo.m:100) and
    lie on this rank's device.  `warmup` and `samples` override
    cfg.sapg.warmup and cfg.sapg.samples (the bare stepper passes 1 and its
    step count: no warm-up iterations).  `graphs`: the iterations replay as
    CUDA graphs (_GraphIterations) where resolve_graph_replay holds for the
    rank's step, else they run eagerly.

    Returns a dict: start(X0) -> the warm-up's first carry; warm(carry,
    draw) -> (carry, logpi_wu (n_warm, D_l), logpi0 (D_l,)); scan(carry,
    iis, draw) -> (carry, host traces of
    (T, D_l)); init_x(x0) -> X0; and local (the rank's problem indices),
    rows (its chains' slice of a problem's C), n_chains (C), n_warm,
    psf_names, consts, aux, group (the chains group, None for one rank),
    data_group, iterations (the _Iterations)."""
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

    def start(X):
        """The warm-up's first carry (X, X̂, prox) from X; the initial prox
        (A2 on the card) takes λθ₀ per problem, per chain."""
        prox = aux["prox_b"](X, (consts["lam"] * aux["theta0"]).repeat_interleave(C_l))[0]
        return X, blur.rfft(X), prox

    n_cols = (cfg.sapg.samples if samples is None else samples) + 1
    use_graphs = graphs and resolve_graph_replay(
        cfg.sapg, aux["route"], blur.fft_mode, device, shape, C_l)
    its = (_GraphIterations if use_graphs else _Iterations)(
        step, aux, consts, blur, D_l, C_l, n_warm, n_cols)

    def warm(carry, draw):
        """Warm-up (SAPG_algorithm_Guassian.m:67-93) from start's carry."""
        with span("sapg.warmup"):
            for t in range(n_warm):
                with span("sapg.warm_step"):
                    with span("sapg.noise"):
                        Z = draw()
                    carry = its.warm(carry, t, Z)
        X, Xhat, prox = carry
        # logPiTraceX(1): logPi at the warm-start sample with the init params
        logpi0 = aux["logpi_init"](Xhat, aux["tv_b"](X), consts)
        carry = (X, Xhat, prox, theta0, consts["sigma2_init"].clone(), dict(params0))
        if cfg.sapg.track_posterior_moments:
            carry += (dict(pm_mean=torch.zeros_like(X), pm_m2=torch.zeros_like(X),
                           pm_count=0.0),)
        return carry, its.logpi_wu.T, logpi0

    def scan(carry, iis, draw):
        """The main iterations iis (a range); host traces {name: (T, D_l)},
        read back once."""
        with span("sapg.segment"):
            for ii in iis:
                with span("sapg.step"):
                    with span("sapg.noise"):
                        Z = draw()
                    carry = its.main(carry, ii, Z)
            return carry, its.traces(iis)

    return dict(
        start=start, warm=warm, scan=scan, init_x=init_x, local=local, iterations=its,
        rows=slice(ci * C_l, (ci + 1) * C_l),
        n_chains=C, chains_per_shard=C_l, n_warm=n_warm, psf_names=aux["psf_names"],
        consts=consts, aux=aux, group=group, n_group=S,
        data_group=mesh.get_group(DATA_AXIS) if Dm > 1 else None, shape=shape,
        device=device, dtype=dtype,
    )


class _Iterations:
    """The rank's warm-up and SAPG iterations, eagerly.  warm(carry, t, Z)
    and main(carry, ii, Z) run one, storing its trace on the device: the
    warm-up's logπ at column t of `logpi_wu` (D_l, n_warm), the step's
    trace at column ii of `buf` (rows `names`, then D_l), read back a
    segment at a time (traces).  warm_iter and main_iter are the
    iterations themselves, with t and ii host ints or device indices
    (_GraphIterations captures them)."""

    def __init__(self, step, aux, consts, blur, D_l, C_l, n_warm, n_cols):
        self.step, self.aux, self.consts = step, aux, consts
        self.n_cols, self.D_l = n_cols, D_l
        self.shape = (D_l * C_l,) + tuple(blur.shape)
        self.dtype, self.device = blur.dtype, blur.device
        self.logpi_wu = torch.empty((D_l, n_warm), dtype=self.dtype, device=self.device)
        self.names = self.buf = None

    def begin(self) -> None:
        """Called as a run starts."""

    def warm_iter(self, carry, t, Z):
        carry, logpi = self.aux["warm_step"](carry, self.consts, Z)
        with span("sapg.trace"):
            _store(self.logpi_wu, t, logpi)
        return carry

    def main_iter(self, carry, ii, Z):
        carry, tr = self.step(carry, ii, self.consts, Z)
        with span("sapg.trace"):
            if self.buf is None:
                self.names = list(tr)
                self.buf = torch.empty((len(self.names), self.D_l, self.n_cols),
                                       dtype=self.dtype, device=self.device)
            _store(self.buf, ii, torch.stack([tr[n] for n in self.names]))
        return carry

    def warm(self, carry, t: int, Z):
        counters.add("graph.eager_steps")
        return self.warm_iter(carry, t, Z)

    def main(self, carry, ii: int, Z):
        counters.add("graph.eager_steps")
        return self.main_iter(carry, ii, Z)

    def traces(self, iis: range) -> dict:
        """The host copy of the traces of iterations iis, {name: (T, D_l)}
        (one read)."""
        if not len(iis):
            return {}
        host = self.buf[..., iis.start:iis.stop].cpu().numpy()
        return {n: host[i].T for i, n in enumerate(self.names)}


class _GraphIterations(_Iterations):
    """The rank's iterations as CUDA graphs, as estimator._GraphLoop runs a
    run on one card: static carry buffers (θ, σ² and the PSF parameters as
    rows of one (2 + P, D_l) block), a static noise field Z and a device
    index a kind, the first iteration of a kind run eagerly on the capture
    stream, then captured and replayed by every later iteration of the
    runs that keep these iterations (run_sapg_sharded keeps them in the
    first problem's step_graphs).

    The step's all_reduce over the chains group stays out of the graphs: the
    capture ends a graph where the step calls it (aux["cuts"]) and goes on
    in the next, in the same memory pool, and a replay runs the graphs in
    turn with the all_reduce of the captured statistics between them,
    eagerly, as the eager step runs it.  So a replayed iteration costs the
    host its draw, two graph launches and the collective's own call."""

    def __init__(self, step, aux, consts, blur, D_l, C_l, n_warm, n_cols):
        super().__init__(step, aux, consts, blur, D_l, C_l, n_warm, n_cols)
        dtype, device, shape = self.dtype, self.device, self.shape
        self.stream = torch.cuda.Stream(device)
        X = torch.empty(shape, dtype=dtype, device=device)
        Xhat = torch.empty(shape[:-1] + (shape[-1] // 2 + 1,), dtype=blur.cdtype,
                           device=device)
        prox = torch.empty_like(X)
        self.param_names = list(aux["params0"])
        self.scal = torch.empty((2 + len(self.param_names), D_l), dtype=dtype, device=device)
        self.static = {
            "warm": (X, Xhat, prox),
            "main": (X, Xhat, prox, self.scal[0], self.scal[1],
                     {n: self.scal[2 + i] for i, n in enumerate(self.param_names)}),
        }
        self.Z = torch.empty_like(X)
        self.index = {k: torch.zeros((1,), dtype=torch.int64, device=device)
                      for k in self.static}
        self.fns = {"warm": self.warm_iter, "main": self.main_iter}
        self.graphs, self.next = {}, {}

    def begin(self) -> None:
        self.next = {}

    def warm(self, carry, t: int, Z):
        return self._iterate("warm", carry, t, Z)

    def main(self, carry, ii: int, Z):
        return self._iterate("main", carry, ii, Z)

    def _pairs(self, kind, carry):
        static = self.static[kind]
        pairs = list(zip(static[:5], carry[:5]))
        if kind == "main":
            pairs += [(static[5][n], carry[5][n]) for n in self.param_names]
        return pairs

    def _iterate(self, kind, carry, i, Z):
        if kind not in self.graphs:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                carry = self.fns[kind](carry, i, Z)
            cur.wait_stream(self.stream)
            counters.add("graph.eager_steps")
            self._capture(kind)
            return carry
        for buf, value in self._pairs(kind, carry):
            if value is not buf:
                buf.copy_(value)
        if self.next.get(kind) != i:
            self.index[kind].fill_(i)
        self.Z.copy_(Z)
        pieces, sums, captured = self.graphs[kind]
        for k, graph in enumerate(pieces):
            graph.replay()
            if k < len(sums):
                self.aux["all_reduce"](sums[k])
        self.next[kind] = i + 1
        counters.add("graph.replays")
        profiling.replayed(captured)
        return self.static[kind]

    def _capture(self, kind) -> None:
        static, pool = self.static[kind], torch.cuda.graph_pool_handle()
        pieces, sums = [], []

        def begin():
            pieces.append(torch.cuda.CUDAGraph())
            pieces[-1].capture_begin(pool=pool, capture_error_mode="thread_local")

        def cut(packed):
            pieces[-1].capture_end()
            sums.append(packed)
            begin()

        with span("sapg.capture"), profiling.capturing() as captured, \
                torch.cuda.stream(self.stream):
            self.aux["cuts"].append(cut)
            try:
                begin()
                out = self.fns[kind](static, self.index[kind], self.Z)
                for buf, value in zip(static[:3], out[:3]):
                    buf.copy_(value)
                if kind == "main":
                    torch.stack([out[3], out[4]] + [out[5][n] for n in self.param_names],
                                out=self.scal)
                self.index[kind].add_(1)
            except BaseException:
                try:
                    pieces[-1].capture_end()
                except RuntimeError:
                    pass   # the capture was invalidated by the error raised
                raise
            finally:
                self.aux["cuts"].pop()
            pieces[-1].capture_end()
        counters.add("graph.captures")
        self.graphs[kind] = (pieces, sums, captured)


def _iterations_for(problems, mesh, chains_per_shard, route, graphs) -> dict:
    """build_sharded_sapg's dict for a run: where its iterations replay as
    CUDA graphs, the one kept in the first problem's step_graphs for these
    problems, this mesh, chain count and route (a new one kept there in
    place of any other), else a new one."""
    built = None
    if graphs:
        key = ("sharded", int(chains_per_shard), route)
        kept = problems[0].step_graphs.get(key)
        if kept is not None and kept["mesh"] is mesh and len(kept["problems"]) == len(problems) \
                and all(a is b for a, b in zip(kept["problems"], problems)):
            built = kept
    if built is None:
        built = build_sharded_sapg(problems, mesh, chains_per_shard, route=route, graphs=graphs)
        if isinstance(built["iterations"], _GraphIterations):
            built.update(mesh=mesh, problems=list(problems))
            problems[0].step_graphs.clear()
            problems[0].step_graphs[key] = built
    built["iterations"].begin()
    return built


def _problem_sources(problems, generators, noise, seeds, built):
    """One draw() of the step's noise for the rank's chains: each local
    problem's whole field (or seeds) from its own source, its rows kept.
    Seeds or normals as the step's rule picks them for one problem's
    chains on the rank (its chains_per_shard)."""
    aux, local, rows, C = built["aux"], built["local"], built["rows"], built["n_chains"]
    shape = (C,) + built["shape"]
    gens = [generators] if isinstance(generators, torch.Generator) else list(generators or [])
    if gens and len(gens) != len(problems):
        raise ValueError(f"{len(gens)} generators for {len(problems)} problems")
    ikr = aux["in_kernel_rng"](built["chains_per_shard"])
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

    def kept(field):
        """The rank's rows of a problem's whole field; counts the elements
        drawn and kept (`noise.drawn`, `noise.kept`)."""
        part = field[rows]
        counters.add("noise.drawn", field.numel())
        counters.add("noise.kept", part.numel())
        return part

    def draw():
        parts = [src() if whole else kept(src()) for src in sources]
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
    with span("sapg.gather"):
        dist.all_gather_object(parts, v, group=built["group"])
        return np.concatenate([p.reshape((D_l, C_l) + v.shape[1:]) for p in parts], axis=1)


def _gather_data(items: list, built) -> list:
    """The per-problem items of every data index, in problem order."""
    if built["data_group"] is None:
        return items
    parts = [None] * dist.get_world_size(built["data_group"])
    with span("sapg.gather"):
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
    _graphs: bool = True,
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
    carry) gets the rank's carry (X, Xhat, prox, θ, σ², params[, extra]);
    where the iterations replay as CUDA graphs that carry is the graphs'
    buffers, valid until the next iteration.  _graphs=False runs the step
    eagerly where the graphs would engage (for tests)."""
    if dist.is_initialized() and dist.get_world_size() > 1 and checkpoint_backend == "npz" \
            and checkpoint_path is not None:
        raise ValueError("a multi-process run checkpoints to a directory: "
                         "checkpoint_backend='orbax'")
    with span("sapg.run"):
        with span("sapg.prologue"):
            built = _iterations_for(problems, mesh, chains_per_shard, route, _graphs)
            cfg = problems[0].cfg
            device = built["device"]
            draw, gens = _problem_sources(problems, generators, noise, seeds, built)

            t0 = time.perf_counter()
            resume = checkpoint_path is not None and os.path.exists(checkpoint_path)
            logpi = {}
            if not resume:
                carry = built["start"](built["init_x"](x0))
        if resume:
            carry = None   # restore_fn supplies it, with the warm-up trace
        else:
            carry, logpi["wu"], logpi["0"] = built["warm"](carry, draw)

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
        with span("sapg.assemble"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            exec_time = time.perf_counter() - t0
            fold_sweeps()
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
    built = build_sharded_sapg(problems, mesh, chains_per_shard, warmup=1, route=route,
                               samples=n_steps + 1)
    draw, _ = _problem_sources(problems, generators, None, None, built)
    carry, _, _ = built["warm"](built["start"](built["init_x"]()), draw)
    carry, traces = built["scan"](carry, range(2, n_steps + 2), draw)
    per_problem = _gather_data(
        [(traces["theta"][:, i], float(carry[4][i])) for i in range(len(built["local"]))], built)
    state = dict(X=carry[0], theta=np.array([t[-1] for t, _ in per_problem]),
                 sigma2=np.array([s for _, s in per_problem]), n_chains=built["n_chains"])
    return state, np.stack([t for t, _ in per_problem])
