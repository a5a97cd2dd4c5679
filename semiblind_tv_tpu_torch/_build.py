"""Build and load the CUDA kernel library (`csrc/tv_kernels.cu`).

The source has a plain C interface and includes no PyTorch header, so it is
compiled by `nvcc` alone into `build/kernels/libsemiblind_tv_kernels.so`
at the root of the checkout, at first use, and loaded with `ctypes`.  The
build is redone whenever the source or the flags change (their hash is kept
beside the library).  Nothing here runs at import time: the CPU tests import
every module of the port on machines without `nvcc`.

Flags: `sm_90a` (Hopper), `-O3`, and `--fmad=false` so that the kernels'
elementwise arithmetic rounds like PyTorch's separate operations (a later
performance change may lift it and re-measure).  `-Xptxas -v` makes the
register and spill report part of `BUILD_LOG`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["load_library", "BUILD_DIR", "SOURCE"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tv_kernels.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_LIB_NAME = "libsemiblind_tv_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
BUILD_LOG = ""          # nvcc's output of the last build made by this process
BUILD_SECONDS = None    # wall time of that build (None: the library was cached)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "sb_num_tiles": ([_I, _I], _I),
    "sb_chambolle_prox": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _F, _F, _P],
        _I,
    ),
    "sb_myula_prox_tv": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _F, _F, _I, _P],
        _I,
    ),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _digest() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def load_library() -> ctypes.CDLL:
    """Build (if the source changed) and load the kernel library; cached."""
    global _lib, BUILD_LOG, BUILD_SECONDS
    if _lib is not None:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, _LIB_NAME)
    stamp = lib_path + ".sha256"
    digest = _digest()
    cached = os.path.isfile(lib_path) and os.path.isfile(stamp)
    if cached:
        with open(stamp) as f:
            cached = f.read().strip() == digest
    if not cached:
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_LOG}"
            )
        os.replace(tmp, lib_path)
        with open(stamp, "w") as f:
            f.write(digest)
    lib = ctypes.CDLL(lib_path)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib
