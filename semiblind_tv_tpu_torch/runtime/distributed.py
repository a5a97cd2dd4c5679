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

`spawn(fn, world_size, args)` starts a gloo world of `world_size`
processes on the CPU (torch.multiprocessing, a FileStore in a temporary
directory: no port is picked by hand) and returns what `fn(rank, *args)`
returned on each rank — the counterpart of the JAX package's virtual CPU
mesh for `run_demo --space-mesh S --device cpu` and the tests.

    from semiblind_tv_tpu_torch.runtime.distributed import initialize
    initialize("cuda")                    # torchrun's world, or one process
    mesh = make_mesh(data=2, chains=dist.get_world_size() // 2)
    run_sapg_sharded(problems, mesh, generators, ...)
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "initialize", "is_multi_host", "local_slice_info", "backend_for", "group_options",
    "spawn", "world_size", "TIMEOUT",
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


def _spawned(rank, fn, n, store_path, out_dir, device_type, backend, timeout_s, args):
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    initialize(device_type, datetime.timedelta(seconds=timeout_s), store_path, n, rank, backend)
    try:
        out = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (), device_type: str = "cpu",
          backend: Optional[str] = None, timeout: float = 600.0) -> List:
    """Run fn(rank, *args) in `world_size` new processes joined in one group
    (a FileStore in a fresh temporary directory; every group's timeout
    `timeout` seconds; one thread each) and return the ranks' return values
    in rank order.  Raises if a process fails.  fn must be importable by
    name (a module's top-level function)."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="semiblind_spawn_")
    try:
        mp.spawn(_spawned, args=(fn, world_size, os.path.join(tmp, "store"), tmp, device_type,
                                 backend, float(timeout), tuple(args)),
                 nprocs=world_size, join=True)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
