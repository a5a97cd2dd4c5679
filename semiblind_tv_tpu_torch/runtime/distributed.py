"""Process groups for the parallel path (port of
`semiblind_tv_tpu/runtime/distributed.py`).

JAX runs one controller over every device of a pod; PyTorch runs one
process a rank, and `torch.distributed` joins them.  `initialize()` sets up
the default group once:

  * under `torchrun` (RANK, WORLD_SIZE and MASTER_ADDR in the environment),
    from that environment (`env://`);
  * otherwise a one-process world on a `FileStore` in a fresh temporary
    directory, so that a single process runs the sharded code unchanged.

NCCL for `cuda`, gloo for the CPU.  On `cuda` each rank takes
`cuda:{local_rank}` and a world with more ranks on a host than the host
has cards raises (there is no fallback to the CPU).  Every group gets an
explicit timeout (`TIMEOUT`, or the caller's).

`start_world(fn, world_size, args)` starts ranks 1 … world_size − 1 of a
new world from a running process, each in a process of its own running
`fn(rank, *args)` on card `rank` (NCCL) or on the CPU (gloo), and joins it
as rank 0 on card 0; the returned `World` ends it (`close()`, or the end of
a `with` block).  A FileStore in a fresh temporary directory (no port is
picked by hand), an explicit timeout, and a rank that fails before it
joins is an error in rank 0 at once; a world larger than the host's cards
raises.  On `cuda` every rank runs on whole cores of its own
(`placement`; rank 0 gets its CPUs back when the world ends).  This is how `run_demo --mesh DxC` runs without
`torchrun`.

`spawn(fn, world_size, args)` starts every rank of a world (gloo on the
CPU by default) in new processes, the caller staying outside it, and
returns what `fn(rank, *args)` returned on each rank — the tests' worlds.
A rank started either way exits when the process that started it does.

    from semiblind_tv_tpu_torch.runtime.distributed import initialize
    initialize("cuda")                    # torchrun's world, or one process
    with start_world(worker, 4):          # or ranks 1-3 running worker(rank)
        ...
    mesh = make_mesh(data=2, chains=dist.get_world_size() // 2)
    run_sapg_sharded(problems, mesh, generators, ...)
"""
from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from semiblind_tv_tpu_torch.runtime.profiling import span

__all__ = [
    "initialize", "is_multi_host", "local_slice_info", "backend_for", "group_options",
    "spawn", "start_world", "World", "placement", "world_size", "TIMEOUT",
]

TIMEOUT = datetime.timedelta(seconds=600)


def backend_for(device_type: str) -> str:
    """NCCL for `cuda`, gloo otherwise."""
    return "nccl" if torch.device(device_type).type == "cuda" else "gloo"


def group_options(backend: str, timeout: datetime.timedelta):
    """Backend options carrying `timeout`, for the groups a DeviceMesh makes."""
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
    else:
        opts = dist.ProcessGroupGloo._Options()
    opts._timeout = timeout
    return opts


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def _take_card(device_type: str, share: bool = False) -> None:
    """On `cuda`, make cuda:{local_rank} this process's device; raise when
    the host has no such card, unless `share` (gloo: ranks may share a
    card, rank r taking card r mod count)."""
    if torch.device(device_type).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    local = _local_rank()
    if share:
        local %= torch.cuda.device_count()
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} has no card: {torch.cuda.device_count()} on "
                           "this host (a world larger than its cards does not fall back to "
                           "the CPU)")
    torch.cuda.set_device(local)


def initialize(
    device_type: str = "cuda",
    timeout: Optional[datetime.timedelta] = None,
    store_path: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Set up the default process group; a no-op when one exists.

    From torchrun's environment when it is set; from a FileStore at
    `store_path` with `world_size` and `rank` when they are given (spawn);
    otherwise a one-process world on a FileStore in a temporary directory.
    `backend` overrides backend_for(device_type) (gloo on CUDA tensors:
    two ranks sharing one card, which NCCL refuses)."""
    if dist.is_initialized():
        backend = dist.get_backend()
    backend = backend or backend_for(device_type)
    _take_card(device_type, share=backend == "gloo")
    if dist.is_initialized():
        return
    timeout = TIMEOUT if timeout is None else timeout
    if store_path is None and "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return
    if store_path is None:
        store_path = os.path.join(tempfile.mkdtemp(prefix="semiblind_world_"), "store")
        world_size, rank = 1, 0
    store = dist.FileStore(store_path, int(world_size))
    dist.init_process_group(backend, store=store, rank=int(rank), world_size=int(world_size),
                            timeout=timeout)


def world_size() -> int:
    """Ranks of the default group (1 before initialize)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multi_host() -> bool:
    """More than one host in the world (torchrun's WORLD_SIZE above its
    LOCAL_WORLD_SIZE)."""
    ws = int(os.environ.get("WORLD_SIZE", world_size()))
    return ws > int(os.environ.get("LOCAL_WORLD_SIZE", ws))


def local_slice_info() -> dict:
    n = world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return dict(
        process_index=dist.get_rank() if dist.is_initialized() else 0,
        process_count=n,
        local_devices=local,
        global_devices=n,
    )


def _exit_with_parent() -> None:
    """Exit (code 1) when the process that started this one ends: a rank
    whose rank 0 died, or was killed, does not wait out its timeout."""
    parent = multiprocessing.parent_process()
    if parent is None:
        return

    def watch():
        multiprocessing.connection.wait([parent.sentinel])
        os._exit(1)

    threading.Thread(target=watch, name="semiblind-parent", daemon=True).start()


def placement(world_size: int) -> Optional[List[List[int]]]:
    """CPU sets for the ranks of a world on this host: disjoint sets of
    whole cores (a core's hyperthreads together) of this process's CPUs,
    an equal share each, in the order the CPUs are numbered.  None where
    there are fewer cores than ranks.  A rank's eager step loop sets the
    world's pace with its host thread (every rank waits for the slowest at
    the step's all_reduce), so no two ranks share a core's hyperthreads."""
    mine = sorted(os.sched_getaffinity(0))
    cores = {}
    for c in mine:
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/core_id") as f:
                core = int(f.read())
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/physical_package_id") as f:
                core = (int(f.read()), core)
        except (OSError, ValueError):
            core = (0, c)
        cores.setdefault(core, []).append(c)
    per = len(cores) // world_size
    if per < 1:
        return None
    order = sorted(cores, key=lambda k: cores[k][0])
    return [sorted(c for k in order[r * per:(r + 1) * per] for c in cores[k])
            for r in range(world_size)]


def _pin(cpus) -> None:
    """Every thread of this process onto `cpus` (threads started later
    inherit it from the thread that starts them)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # a thread that ended meanwhile
            pass


def _child(i, first, fn, n, out_dir, device_type, backend, timeout_s, args, cpus=None):
    """Rank first + i of a world of n, in a process of its own: takes its
    CPUs (cpus[rank], where given) and its card, leaves `up<rank>` in
    out_dir, joins the group on the FileStore there, runs fn(rank, *args)
    and pickles what it returns."""
    rank = first + i
    if cpus is not None:
        _pin(cpus[rank])
    _exit_with_parent()
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    backend = backend or backend_for(device_type)
    _take_card(device_type, share=backend == "gloo")
    open(os.path.join(out_dir, f"up{rank}"), "w").close()
    initialize(device_type, datetime.timedelta(seconds=timeout_s),
               os.path.join(out_dir, "store"), n, rank, backend)
    try:
        out = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _launch(fn, first, n, out_dir, device_type, backend, timeout_s, args, daemon=False,
            cpus=None):
    """Ranks first … n − 1 started (torch.multiprocessing, spawn), rank r on
    cpus[r] where given; their ProcessContext, whose join() raises when one
    of them failed."""
    import torch.multiprocessing as mp

    return mp.start_processes(_child, args=(first, fn, n, out_dir, device_type, backend,
                                            float(timeout_s), tuple(args), cpus),
                              nprocs=n - first, join=False, daemon=daemon, start_method="spawn")


def _results(out_dir, ranks) -> List:
    out = []
    for r in ranks:
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def spawn(fn: Callable, world_size: int, args: Sequence = (), device_type: str = "cpu",
          backend: Optional[str] = None, timeout: float = 600.0) -> List:
    """Run fn(rank, *args) in `world_size` new processes joined in one group
    (a FileStore in a fresh temporary directory; every group's timeout
    `timeout` seconds; one thread each) and return the ranks' return values
    in rank order.  Raises if a process fails.  fn must be importable by
    name (a module's top-level function)."""
    tmp = tempfile.mkdtemp(prefix="semiblind_spawn_")
    try:
        ctx = _launch(fn, 0, world_size, tmp, device_type, backend, timeout, args)
        while not ctx.join():
            pass
        return _results(tmp, range(world_size))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class World:
    """A world start_world started, held by its rank 0 (the caller).

    close() leaves the default group, waits up to the world's timeout for
    ranks 1 … to end and returns what fn returned on each (raising if one
    failed); abort() stops them.  Either gives rank 0 back the CPUs it had
    before the world (`cpus`).  As a context manager it closes on a normal
    exit and aborts on an exception; either ends it once."""

    def __init__(self, ctx, out_dir: str, size: int, timeout_s: float, cpus=None):
        self.ctx, self.out_dir, self.size, self.timeout_s = ctx, out_dir, size, timeout_s
        self.cpus = cpus
        self.results: Optional[List] = None
        self.ended = False

    def close(self) -> List:
        if self.ended:
            return self.results
        if dist.is_initialized():
            dist.destroy_process_group()
        try:
            deadline = time.monotonic() + self.timeout_s
            while not self.ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ranks 1-{self.size - 1} still running "
                                       f"{self.timeout_s:.0f} s after rank 0 left the world")
            self.results = _results(self.out_dir, range(1, self.size))
            return self.results
        finally:
            self.abort()

    def abort(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(self.out_dir, ignore_errors=True)
        if self.cpus is not None and not self.ended:
            _pin(self.cpus)
        self.ended = True

    def __enter__(self) -> "World":
        return self

    def __exit__(self, kind, *_) -> bool:
        if kind is None:
            self.close()
        else:
            self.abort()
        return False


def start_world(fn: Callable, world_size: int, args: Sequence = (), device_type: str = "cuda",
                timeout: Union[float, datetime.timedelta] = TIMEOUT) -> World:
    """Start ranks 1 … world_size − 1 of a new world, each in a process of
    its own running fn(rank, *args) on card `rank` (or the CPU), and join it
    as rank 0 here, on card 0; returns the World that ends it.

    NCCL on `cuda`, gloo on the CPU; the group's timeout `timeout` (seconds
    or a timedelta).  On `cuda` each rank, this one included until the
    world ends, runs on CPUs of its own (placement).  Raises at once where
    the host has fewer cards than ranks, where a group already exists, or
    where a rank fails before it joins; a rank that fails later surfaces in rank 0's next collective (gloo
    at once, NCCL at the timeout) and in close().  fn must be importable by
    name (a module's top-level function); every rank, rank 0 included,
    then makes the same collective calls."""
    if dist.is_initialized():
        raise RuntimeError("start_world: this process is already in a process group")
    n = int(world_size)
    if torch.device(device_type).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > cards:
            raise RuntimeError(f"a world of {n} ranks on cuda needs {n} cards; this host has "
                               f"{cards} (a world larger than its cards does not fall back "
                               "to the CPU)")
    timeout_s = timeout.total_seconds() if isinstance(timeout, datetime.timedelta) \
        else float(timeout)
    with span("world.start"):
        tmp = tempfile.mkdtemp(prefix="semiblind_world_")
        cpus = placement(n) if torch.device(device_type).type == "cuda" else None
        before = sorted(os.sched_getaffinity(0))
        # daemons: a rank 0 that exits on an error stops them on its way out
        world = World(_launch(fn, 1, n, tmp, device_type, None, timeout_s, args, daemon=True,
                              cpus=cpus),
                      tmp, n, timeout_s, cpus=before if cpus is not None else None)
        if cpus is not None:
            _pin(cpus[0])
        try:
            deadline = time.monotonic() + timeout_s
            while not all(os.path.exists(os.path.join(tmp, f"up{r}")) for r in range(1, n)):
                if world.ctx.join(timeout=0.05) or time.monotonic() > deadline:
                    raise TimeoutError(f"ranks 1-{n - 1} did not reach the world in "
                                       f"{timeout_s:.0f} s")
            initialize(device_type, datetime.timedelta(seconds=timeout_s),
                       os.path.join(tmp, "store"), n, 0)
        except BaseException:
            world.abort()
            raise
    return world
