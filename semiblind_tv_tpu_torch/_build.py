"""Build and load the CUDA kernel library from every source under `csrc/`.

The sources have a plain C interface and include no PyTorch header, so
`nvcc` alone compiles each `.cu` file to an object, all of them at once
(one `nvcc` process per source, started together), and links the objects
into `build/kernels/libsemiblind_tv_kernels.so` at the root of the
checkout, at first use; the library is loaded with `ctypes`.  One hash over
every `.cu` and `.cuh` file and the flags is kept beside the library, and
the build is redone whenever it changes.  Nothing here runs at import time:
the CPU tests import every module of the port on machines without `nvcc`.

Flags: `sm_90a` (Hopper), `-O3`, and `--fmad=false` so that the kernels'
elementwise arithmetic rounds like PyTorch's separate operations (a later
performance change may lift it and re-measure).  `-Xptxas -v` makes the
register, shared-memory and spill report of every kernel part of
`BUILD_LOG`, which is kept beside the library (`build.log`), so that
`kernel_usage` reads it for a library that an earlier process built.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["load_library", "kernel_usage", "BUILD_DIR", "LIB_PATH", "SOURCES"]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
SOURCES = tuple(sorted(glob.glob(os.path.join(_CSRC, "*.cu"))))
_HEADERS = tuple(sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_LIB_NAME = "libsemiblind_tv_kernels.so"
LIB_PATH = os.path.join(BUILD_DIR, _LIB_NAME)
LOG_PATH = os.path.join(BUILD_DIR, "build.log")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
BUILD_LOG = ""          # nvcc's output of the last build made by this process
BUILD_SECONDS = None    # wall time of that build (None: the library was cached)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "sb_num_tiles": ([_I, _I], _I),
    "sb_chambolle_prox": (
        [_P] * 11 + [_I] * 7 + [_F, _F, _I, _P],
        _I,
    ),
    "sb_myula_step": (
        [_P] * 16 + [_I] * 7 + [_F, _F, _I, _I, _P],
        _I,
    ),
    "sb_resident_occupancy": ([_P], _I),
    "sb_resident_exact_ops": ([_P] * 4 + [_L, _P], _I),
    "sb_chambolle_prox_blocked": (
        [_P] * 12 + [_I] * 7 + [_F, _F, _I, _P],
        _I,
    ),
    "sb_myula_prox_tv_blocked": (
        [_P] * 17 + [_I] * 7 + [_F, _F, _I, _I, _P],
        _I,
    ),
    "sb_blocked_occupancy": ([_P], _I),
    "sb_blocked_fast_ops": ([_P] * 4 + [_L, _P], _I),
    "sb_myula_prox_tv_dft": (
        [_P] * 27 + [_L] + [_I] * 7 + [_F, _F, _I, _I, _P],
        _I,
    ),
    "sb_myula_prox_tv_irdft": (
        [_P] * 22 + [_L] + [_I] * 7 + [_F, _F, _I, _I, _P],
        _I,
    ),
    "sb_dft_products": (
        [_P] * 14 + [_L] + [_I] * 3 + [_P],
        _I,
    ),
    "sb_dft_host_costs": ([_P, _I, _P], _I),
    "sb_prox_variant": (
        [_I] + [_P] * 6 + [_I] * 6 + [_P],
        _I,
    ),
    "sb_prox_variant_occupancy": ([_I, _P], _I),
    "sb_sapg_stats_span": ([], _I),
    "sb_sapg_residual": ([_P] * 4 + [_I] * 3 + [_L, _P], _I),
    "sb_sapg_stats": (
        [_P] * 13 + [_L] + [_I] * 4 + [_L] + [_I] * 3 + [_F, _P],
        _I,
    ),
    "sb_sapg_update": (
        [_P] * 12 + [_L] + [_I] * 5 + [_F, _P],
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
    for path in SOURCES + _HEADERS:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _build(lib_path: str) -> None:
    """Compile every source in parallel, then link; raises on any failure."""
    global BUILD_LOG, BUILD_SECONDS
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o") for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(SOURCES, objs))
    ]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    tmp = f"{lib_path}.{tag}"
    if not failed:
        cmd = [nvcc, *_ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}")
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = "\n".join(logs)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError("\n".join(failed) + "\n" + BUILD_LOG)
    with open(LOG_PATH, "w") as f:
        f.write(BUILD_LOG)
    os.replace(tmp, lib_path)


def load_library() -> ctypes.CDLL:
    """Build (if a source changed) and load the kernel library; cached."""
    global _lib
    if _lib is not None:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = LIB_PATH
    stamp = lib_path + ".sha256"
    digest = _digest()
    cached = os.path.isfile(lib_path) and os.path.isfile(stamp)
    if cached:
        with open(stamp) as f:
            cached = f.read().strip() == digest
    if not cached:
        _build(lib_path)
        with open(stamp, "w") as f:
            f.write(digest)
    lib = ctypes.CDLL(lib_path)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    return lib


def kernel_usage(name: str) -> dict:
    """ptxas's report of every kernel entry whose mangled name contains
    `name`, from the build of the loaded library: {mangled name: {registers,
    spill_stores, spill_loads, stack, smem}} (bytes but registers)."""
    import re

    load_library()
    text = BUILD_LOG
    if not text and os.path.isfile(LOG_PATH):
        with open(LOG_PATH) as f:
            text = f.read()
    lines = text.splitlines()
    out = {}
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m is None or name not in m.group(1):
            continue
        block = " ".join(lines[i + 1:i + 4])

        def num(pat):
            found = re.search(pat, block)
            return int(found.group(1)) if found else 0

        out[m.group(1)] = dict(
            registers=num(r"Used (\d+) registers"), spill_stores=num(r"(\d+) bytes spill stores"),
            spill_loads=num(r"(\d+) bytes spill loads"), stack=num(r"(\d+) bytes stack frame"),
            smem=num(r"(\d+) bytes smem"))
    return out
