"""runtime/distributed.start_world: a world started from a running process,
which joins it as rank 0, and the sharded SAPG run in that world against the
benchmark's plain reference (portbench/reference/sapg.py).

One module-scoped gloo world of four on the CPU: this process is rank 0 and
ranks 1-3 run `_sharded_run`, all of them run_sapg(mesh=1×4) at 40×56 of
the wheel, 8 chains (2 a rank), float64, fed the whole noise field a step
from one `portbench.inputs.Draws` stream each, as the benchmark's
`gaussian512-b64-4chip` cell runs 64 chains on four cards.  The reference
takes the same draws, so the two agree up to the order of the sums over
the chains.  Also: a rank that fails surfaces in rank 0 as an error, a
world larger than the host's cards raises, the sharded run's counters
(`collective.all_reduce.calls`, `noise.drawn`/`noise.kept`) read one
all_reduce an iteration and a quarter of the noise kept, and the one-card
path moves none of them.  The card test runs the same comparison over NCCL
on four cards, in float32 (skipped with fewer); on a card the sharded run
replays CUDA graphs cut at its all_reduce, and the card tests hold two
graphed runs against the eager run bit for bit, in a gloo world of four
ranks sharing one card and over NCCL on four:

    python -m pytest --noconftest tests/test_torch_world.py -q -k cards

The module imports no JAX: the ranks import it to find `_sharded_run`.
"""
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from portbench import compare, inputs, port
from portbench.reference import problem as refproblem
from portbench.reference import sapg as refsapg
from semiblind_tv_tpu_torch.runtime.distributed import placement, spawn, start_world
from semiblind_tv_tpu_torch.runtime.profiling import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, CHAINS, SEED = 4, 8, 2 ** 31 + 77
COUNTED = ("collective.all_reduce.calls", "collective.all_reduce.bytes", "noise.drawn",
           "noise.kept", "graph.eager_steps", "graph.replays", "graph.captures")
# float64: the sharded run averages each rank's chain means over the ranks,
# the reference takes one mean over the eight chains; the two orders part in
# the last bits, and the SA loop carries that over its few steps
F64_GAP = 1e-12
# float32 on the cards: the kernels against the reference's plain operators
# (fused steps, sums in another order), the benchmark's limit
F32_GAP = 1e-4


def _config():
    with open(os.path.join(ROOT, "portbench", "configs", "gaussian-wheel-512-mesh1x4.json")) as f:
        c = json.load(f)
    c["demo"].update(samples=6, warmup=4, burn_in=4)
    c["sapg_options"].update(samples=6, warmup=4)
    return c


def _inputs(device, dtype):
    img = inputs.image("wheel")[180:220, 150:206]   # 40 x 56: rows and columns differ
    obs = inputs.normal_field(inputs.derive(SEED, "observation"), img.shape, device, dtype)
    return img, obs


def _draws(device, dtype):
    return inputs.Draws(inputs.derive(SEED, "chains", 0), device, dtype)


def _sharded_run(rank, device, dtype):
    """One rank's run_sapg(mesh=1×4) of the 8 chains, with the counters it moved."""
    from semiblind_tv_tpu_torch.parallel.mesh import make_mesh
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    c = _config()
    img, obs = _inputs(device, dtype)
    problem = build_problem(img, port.demo_config(c), device=device, dtype=dtype, noise=obs)
    mesh = make_mesh(1, RANKS, device_type=torch.device(device).type)
    counters.reset(*COUNTED)
    res = run_sapg(problem, n_chains=CHAINS, mesh=mesh, noise=_draws(device, dtype))
    return dict(theta=res.thetas[1:], sigma2=res.sigma2s[1:], X_last=res.X_last,
                counters={n: counters[n] for n in COUNTED})


def _graphs_against_eager(rank, device, dtype):
    """One rank's run_sapg(mesh=1×4) of the 8 chains three times on one
    problem: graphed twice (the second run replays the graphs the first
    kept, from its first iteration on) and eagerly once, with the counters
    each moved."""
    from semiblind_tv_tpu_torch.parallel.mesh import make_mesh
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    img, obs = _inputs(device, dtype)
    problem = build_problem(img, port.demo_config(_config()), device=device, dtype=dtype,
                            noise=obs)
    mesh = make_mesh(1, RANKS, device_type="cuda")
    out = []
    for graphs in (True, True, False):
        counters.reset(*COUNTED)
        res = run_sapg(problem, n_chains=CHAINS, mesh=mesh, noise=_draws(device, dtype),
                       _graphs=graphs)
        out.append(dict(theta=res.thetas, sigma2=res.sigma2s, X_last=res.X_last,
                        counters={n: counters[n] for n in COUNTED}))
    return out


def _reference(device, dtype):
    img, obs = _inputs(device, dtype)
    demo = _config()["demo"]
    return refsapg.run(refproblem.build(img, demo, obs), demo, CHAINS, _draws(device, dtype))


def _gaps(prog, ref):
    return {"theta": compare.trace_gap(prog["theta"], ref["theta"]),
            "sigma2": compare.trace_gap(prog["sigma2"], ref["sigma2"]),
            "X_last": compare.field_gap(prog["X_last"], ref["X_last"])}


@pytest.fixture(scope="module")
def world():
    """Every rank's result of the sharded run, rank 0's computed here, in
    the world's process group, which is gone when the fixture returns."""
    t0 = time.perf_counter()
    with start_world(_sharded_run, RANKS, ("cpu", torch.float64), device_type="cpu",
                     timeout=60) as w:
        assert dist.get_rank() == 0 and dist.get_world_size() == RANKS
        own = _sharded_run(0, "cpu", torch.float64)
        others = w.close()
    assert not dist.is_initialized()
    return dict(ranks=[own] + others, seconds=time.perf_counter() - t0)


def _fails_on_rank_1(rank):
    if rank == 1:
        raise ValueError("rank 1 fails")
    dist.all_reduce(torch.ones(1))


def test_the_world_starts_and_every_rank_joins(world):
    assert len(world["ranks"]) == RANKS
    first = world["ranks"][0]
    for other in world["ranks"][1:]:
        for k in ("theta", "sigma2", "X_last"):
            np.testing.assert_array_equal(other[k], first[k])
    assert first["X_last"].shape == (CHAINS, 40, 56)


def test_a_rank_that_fails_is_an_error_in_rank_0():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        with start_world(_fails_on_rank_1, 2, device_type="cpu", timeout=30):
            _fails_on_rank_1(0)
    assert time.perf_counter() - t0 < 30
    assert not dist.is_initialized()


def _cpus_of(cpu):
    """The CPUs of `cpu`'s core (its hyperthreads), as the host lists them."""
    try:
        with open(f"/sys/devices/system/cpu/cpu{cpu}/topology/thread_siblings_list") as f:
            text = f.read().strip()
    except OSError:
        return {cpu}
    out = set()
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.update(range(int(a), int(b or a) + 1))
    return out


@pytest.mark.parametrize("ranks", [1, 2])
def test_placement_gives_each_rank_whole_cores_of_its_own(ranks):
    mine = os.sched_getaffinity(0)
    sets = placement(ranks)
    if len({min(_cpus_of(c) & mine) for c in mine}) < ranks:
        assert sets is None
        return
    assert len(sets) == ranks and len({len(s) for s in sets}) == 1
    flat = [c for s in sets for c in s]
    assert len(flat) == len(set(flat)) and set(flat) <= mine
    for s in sets:
        for c in s:
            assert _cpus_of(c) & mine <= set(s)
    assert placement(len(mine) + 1) is None


def _joins(rank):
    dist.all_reduce(torch.ones(1))
    return sorted(os.sched_getaffinity(0))


def test_a_cpu_world_leaves_the_cpus_alone():
    before = sorted(os.sched_getaffinity(0))
    with start_world(_joins, 2, device_type="cpu", timeout=30) as w:
        assert _joins(0) == before
        assert w.close() == [before]
    assert sorted(os.sched_getaffinity(0)) == before


def test_a_world_larger_than_the_cards_raises():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="cards"):
        start_world(_fails_on_rank_1, cards + 1, device_type="cuda")
    assert not dist.is_initialized()


def test_sharded_run_agrees_with_the_reference(world):
    gaps = _gaps(world["ranks"][0], _reference("cpu", torch.float64))
    assert max(gaps.values()) < F64_GAP, gaps


def test_one_all_reduce_an_iteration_and_a_quarter_of_the_noise(world):
    c = _config()["demo"]
    warm, main = c["warmup"] - 1, c["samples"] - 1
    for rank in world["ranks"]:
        n = rank["counters"]
        assert n["graph.eager_steps"] == warm + main and n["graph.replays"] == 0
        # each warm-up and SAPG step merges its statistics once; the initial logπ once a run
        assert n["collective.all_reduce.calls"] == warm + main + 1
        assert n["collective.all_reduce.bytes"] > 0
        assert n["noise.drawn"] == (warm + main) * CHAINS * 40 * 56
        assert n["noise.kept"] * RANKS == n["noise.drawn"]


def test_the_one_card_path_moves_no_new_counter_or_span():
    from semiblind_tv_tpu_torch.runtime import profiling
    from semiblind_tv_tpu_torch.runtime.problem import build_problem
    from semiblind_tv_tpu_torch.sapg.estimator import run_sapg

    img, obs = _inputs("cpu", torch.float64)
    problem = build_problem(img, port.demo_config(_config()), device="cpu", dtype=torch.float64,
                            noise=obs)
    profiling.reset()
    profiling.enable()
    try:
        run_sapg(problem, n_chains=CHAINS, noise=_draws("cpu", torch.float64))
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        profiling.reset()
    assert not {n for n in snap["counters"] if n.startswith(("collective.", "noise."))}
    assert not {s["name"] for s in snap["spans"]} & {"sapg.allreduce", "sapg.gather",
                                                      "world.start"}


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} CUDA cards: torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return "cuda"


def test_sharded_run_over_nccl_on_four_cards(four_cards):
    torch.backends.cuda.matmul.allow_tf32 = False
    before, sets = os.sched_getaffinity(0), placement(RANKS)
    with start_world(_sharded_run, RANKS, ("cuda", torch.float32), device_type="cuda",
                     timeout=120) as w:
        assert dist.get_backend() == "nccl"
        assert sets is None or sorted(os.sched_getaffinity(0)) == sets[0]
        own = _sharded_run(0, "cuda", torch.float32)
        others = w.close()
    assert os.sched_getaffinity(0) == before
    for other in others:
        np.testing.assert_array_equal(other["theta"], own["theta"])
    gaps = _gaps(own, _reference("cuda", torch.float32))
    assert max(gaps.values()) < F32_GAP, gaps
    assert own["counters"]["noise.kept"] * RANKS == own["counters"]["noise.drawn"]


@pytest.mark.parametrize("backend,cards", [("gloo", 1), ("nccl", RANKS)],
                         ids=["one card, gloo", "four cards, nccl"])
def test_sharded_graphs_on_cards_replay_the_eager_run(backend, cards):
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA card(s): torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from semiblind_tv_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()   # built here, not raced by the ranks
    args = ("cuda", torch.float32)
    if backend == "gloo":
        ranks = spawn(_graphs_against_eager, RANKS, args, device_type="cuda", backend="gloo",
                      timeout=120)
    else:
        with start_world(_graphs_against_eager, RANKS, args, device_type="cuda",
                         timeout=120) as w:
            ranks = [_graphs_against_eager(0, *args)] + w.close()
    c = _config()["demo"]
    warm, main = c["warmup"] - 1, c["samples"] - 1
    for graphed, again, eager in ranks:
        for run in (graphed, again):
            for k in ("theta", "sigma2", "X_last"):
                np.testing.assert_array_equal(run[k], eager[k], err_msg=k)
        n = [r["counters"] for r in (graphed, again, eager)]
        # the first graphed run captures each kind after its first, eager, iteration
        assert (n[0]["graph.captures"], n[0]["graph.eager_steps"]) == (2, 2)
        assert n[0]["graph.replays"] == warm + main - 2
        assert (n[1]["graph.captures"], n[1]["graph.eager_steps"]) == (0, 0)
        assert n[1]["graph.replays"] == warm + main
        assert (n[2]["graph.replays"], n[2]["graph.eager_steps"]) == (0, warm + main)
        # the all_reduce runs between the graphs: one a warm-up and SAPG
        # iteration and the initial logπ's, in every run
        assert all(k["collective.all_reduce.calls"] == warm + main + 1 for k in n)
    np.testing.assert_array_equal(ranks[1][0]["theta"], ranks[0][0]["theta"])
