"""Checkpoint / results persistence (port of
`semiblind_tv_tpu/runtime/checkpoint.py`, which this package may not import:
importing any `semiblind_tv_tpu` submodule pulls in jax).

The reference's de-facto checkpoint format is the end-of-run `results`
struct saved as .mat (full iterate traces + last sample + options —
SAPG_algorithm_Guassian.m:250-306, SALSA/runStats.m).  Here:

  * `save_results` / `load_results` — the same schema as compressed NPZ
    (`sapg/<field>`, `sapg/<field>/<key>`, `sapg/scalar/<field>`,
    `salsa/<field>`).  A field that is None (the posterior moments of a run
    without them) is left out: NPZ holds it only as a pickled object array,
    which `load_results` (allow_pickle=False) cannot read back.
  * Mid-run checkpoint/resume of the SAPG scan carry lives with the
    estimator (`sapg/estimator.py::_save_checkpoint`/`_restore_checkpoint`,
    driven by run_sapg's checkpoint_every/checkpoint_path).
  * `save_checkpoint_arrays` / `load_checkpoint_arrays` — the persistence
    layer under the mid-run checkpoint: a flat {name: ndarray} dict written
    atomically as NPZ (`backend="npz"`), or as a directory
    (`backend="orbax"`, the JAX package's name for its Orbax backend, kept
    for the migration surface; Orbax is a JAX library and is not used):
    `torch.distributed.checkpoint` writes it, every rank of a
    multi-process world its own arrays (each rank keys its arrays apart:
    the writer keeps one copy of a key that several ranks hold), the
    directory written under `<path>.tmp` and renamed by rank 0 when every
    rank is done.  `load_checkpoint_arrays` reads a directory as that
    backend and a file as NPZ, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from typing import Any, Dict

import numpy as np

__all__ = [
    "save_results",
    "load_results",
    "run_stats",
    "save_checkpoint_arrays",
    "load_checkpoint_arrays",
    "delete_checkpoint",
]


def _check_backend(backend: str) -> None:
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend {backend!r} (npz|orbax)")


def _world():
    """(rank, world size) of the default process group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier(n: int) -> None:
    if n > 1:
        import torch.distributed as dist

        dist.barrier()


def save_checkpoint_arrays(path: str, arrays: Dict[str, np.ndarray], backend: str = "npz") -> None:
    """Atomically persist a flat dict of host arrays as NPZ or a directory.
    The directory backend is collective in a multi-process world: every
    rank calls it with its own arrays."""
    _check_backend(backend)
    if backend == "npz":
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)
        return
    import torch
    import torch.distributed.checkpoint as dcp

    rank, n = _world()
    tmp = path + ".tmp"
    if rank == 0 and os.path.isdir(tmp):
        shutil.rmtree(tmp)
    _barrier(n)
    state = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    with warnings.catch_warnings():   # "assuming ... a single process": it is one
        warnings.simplefilter("ignore", UserWarning)
        dcp.save(state, checkpoint_id=tmp, no_dist=n == 1)
    _barrier(n)
    if rank == 0:
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    _barrier(n)


def load_checkpoint_arrays(path: str, backend: str | None = None,
                           prefix: str = "") -> Dict[str, np.ndarray]:
    """Load a checkpoint dict; backend auto-detected from the path when None
    (directory → orbax, file → npz).  Only the arrays whose names start
    with `prefix`; each rank reads the directory on its own."""
    if backend is None:
        backend = "orbax" if os.path.isdir(path) else "npz"
    _check_backend(backend)
    if backend == "npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files if k.startswith(prefix)}
    import torch
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in meta.items() if k.startswith(prefix)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(state, checkpoint_id=path, no_dist=True)
    return {k: v.numpy() for k, v in state.items()}


def delete_checkpoint(path: str) -> None:
    """Remove a checkpoint regardless of backend (file or directory)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def save_results(path: str, sapg, salsa=None) -> None:
    """Persist an SAPGResult (+ optional SALSAResult or FISTAResult) as NPZ."""
    arrays: Dict[str, Any] = {}
    for f in dataclasses.fields(sapg):
        v = getattr(sapg, f.name)
        if v is None:
            continue
        if isinstance(v, np.ndarray):
            arrays[f"sapg/{f.name}"] = v
        elif isinstance(v, dict):
            for k, vv in v.items():
                arrays[f"sapg/{f.name}/{k}"] = np.asarray(vv)
        else:
            arrays[f"sapg/scalar/{f.name}"] = np.asarray(v)
    if salsa is not None:
        for f in dataclasses.fields(salsa):
            v = getattr(salsa, f.name)
            if isinstance(v, dict):
                arrays[f"salsa/{f.name}"] = np.asarray(json.dumps(v))
            else:
                arrays[f"salsa/{f.name}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_results(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def run_stats(directory: str) -> Dict[str, float]:
    """Aggregate a directory of results.json files (reference SALSA/runStats.m:
    averages MSE and time over *_results.mat in a results dir)."""
    mses, times, ssims = [], [], []
    for name in sorted(os.listdir(directory)):
        sub = os.path.join(directory, name)
        path = sub if name.endswith(".json") else os.path.join(sub, "results.json")
        if os.path.isfile(path):
            with open(path) as f:
                r = json.load(f)
            if "mse_db" in r:
                mses.append(r["mse_db"])
            if "sapg_time_s" in r:
                times.append(r["sapg_time_s"])
            if "ssim" in r:
                ssims.append(r["ssim"])
    out: Dict[str, float] = {"count": float(len(mses))}
    if mses:
        out["mse_avg"] = float(np.mean(mses))
        out["mse_std"] = float(np.std(mses))
    if times:
        out["time_avg"] = float(np.mean(times))
    if ssims:
        out["ssim_avg"] = float(np.mean(ssims))
    return out
