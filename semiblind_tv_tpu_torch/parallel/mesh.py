"""Device meshes for the parallel path (port of
`semiblind_tv_tpu/parallel/mesh.py`).

  * 'chains' — independent MYULA chains of the SAME problem; the per-chain
    SAPG statistics (4-6 scalars) are averaged over the axis each step (one
    all_reduce a step), so the traffic is O(#hyperparameters) a step.
  * 'data'   — independent problems (images); no reduction across it.
  * 'space'  — the rows of one image (parallel/spatial.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default group, one rank a device (runtime/distributed.initialize: a
one-process world when no group exists).  Hyperparameter state is
replicated along 'chains' and split along 'data'.  Each group the mesh
makes gets the default group's backend and an explicit timeout.
`rank_layout` reads a rank's share of a SAPG run from a mesh: the SAPG
run loop (sapg/estimator.run_sapg_layout) knows no DeviceMesh.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from semiblind_tv_tpu_torch.runtime.distributed import TIMEOUT, group_options, initialize

__all__ = [
    "make_mesh", "make_spatial_mesh", "axis_size", "mesh_device", "RankLayout", "rank_layout",
    "DATA_AXIS", "CHAINS_AXIS", "SPACE_AXIS",
]

DATA_AXIS = "data"
CHAINS_AXIS = "chains"
SPACE_AXIS = "space"


def _mesh(device_type, shape, names, timeout) -> DeviceMesh:
    backend = dist.get_backend()
    opts = group_options(backend, TIMEOUT if timeout is None else timeout)
    return init_device_mesh(device_type, shape, mesh_dim_names=names,
                            backend_override={n: (backend, opts) for n in names})


def make_mesh(
    data: Optional[int] = None,
    chains: Optional[int] = None,
    device_type: str = "cuda",
    timeout: Optional[datetime.timedelta] = None,
) -> DeviceMesh:
    """A ('data', 'chains') mesh over the world's ranks.

    Defaults to data=1 (every rank on chains).  `data * chains` must equal
    the number of ranks: on `cuda` a world smaller than the mesh raises
    rather than falling back to the CPU."""
    initialize(device_type)
    n = dist.get_world_size()
    if data is None and chains is None:
        data, chains = 1, n
    elif data is None:
        data = n // chains
    elif chains is None:
        chains = n // data
    if data * chains != n:
        raise ValueError(f"mesh {data}x{chains} != {n} devices")
    return _mesh(device_type, (data, chains), (DATA_AXIS, CHAINS_AXIS), timeout)


def make_spatial_mesh(
    space: Optional[int] = None,
    device_type: str = "cuda",
    timeout: Optional[datetime.timedelta] = None,
) -> DeviceMesh:
    """1-D ('space',) mesh for row-sharded single-image processing: the
    image's first axis is split into `space` contiguous row blocks, one a
    rank.  `space` must equal the number of ranks."""
    initialize(device_type)
    n = dist.get_world_size()
    space = n if space is None else space
    if space != n:
        raise ValueError(f"spatial mesh of {space} != {n} devices")
    return _mesh(device_type, (space,), (SPACE_AXIS,), timeout)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's shards."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """A rank's share of a SAPG run of D problems × C chains: `problems`,
    the indices of its problems; `rows`, its rows of each problem's C
    chains; `n_group`, the S ranks that hold a problem's chains, and their
    `group` (None for one); the `data_group` of the ranks that hold the
    other problems (None for one); its `rank` in the world, None where there
    is no world (one device); its `device`.  The layout of a run on one
    device holds every problem and chain there."""

    problems: range
    rows: slice
    device: torch.device
    n_group: int = 1
    group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None
    rank: Optional[int] = None


def rank_layout(mesh: DeviceMesh, n_problems: int, chains_per_shard: int) -> RankLayout:
    """This rank's share of n_problems problems of chains_per_shard·S chains
    each on a ('data', 'chains') mesh: data index d holds the d-th block of
    n_problems / data problems, chains index c the rows c·chains_per_shard …
    (c+1)·chains_per_shard − 1 of each."""
    Dm, S = axis_size(mesh, DATA_AXIS), axis_size(mesh, CHAINS_AXIS)
    if n_problems % Dm != 0:
        raise ValueError(f"{n_problems} problems not divisible over data axis {Dm}")
    D_l, C_l = n_problems // Dm, int(chains_per_shard)
    di, ci = mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(CHAINS_AXIS)
    return RankLayout(
        problems=range(di * D_l, (di + 1) * D_l), rows=slice(ci * C_l, (ci + 1) * C_l),
        device=mesh_device(mesh), n_group=S,
        group=mesh.get_group(CHAINS_AXIS) if S > 1 else None,
        data_group=mesh.get_group(DATA_AXIS) if Dm > 1 else None, rank=dist.get_rank(),
    )
