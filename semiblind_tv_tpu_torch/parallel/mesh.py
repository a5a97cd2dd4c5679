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
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from semiblind_tv_tpu_torch.runtime.distributed import TIMEOUT, group_options, initialize

__all__ = [
    "make_mesh", "make_spatial_mesh", "axis_size", "mesh_device",
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
