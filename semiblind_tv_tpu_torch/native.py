"""ctypes binding of the C++ float64 oracle (`native/chambolle.cc`).

The port's own copy of the JAX package's `native` binding: it loads the
repo's `native/libsemiblind_native.so` by path, building it with
`make -C native` first when the library is absent, and exposes the oracle's
Chambolle prox and isotropic TV norm.  The oracle runs on the CPU in
float64; the functions take float64 numpy arrays or CPU tensors, and return
tensors for tensor inputs and numpy arrays otherwise.  `available()` says
whether the library could be built and loaded.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["available", "chambolle_prox_native", "tv_norm_native", "LIB_PATH"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
LIB_PATH = os.path.join(_NATIVE_DIR, "libsemiblind_native.so")
_LIB: Optional[ctypes.CDLL] = None
_D = ctypes.POINTER(ctypes.c_double)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    lib.tv_norm_f64.restype = ctypes.c_double
    lib.tv_norm_f64.argtypes = [_D, ctypes.c_int64, ctypes.c_int64]
    lib.chambolle_prox_f64.restype = ctypes.c_int64
    lib.chambolle_prox_f64.argtypes = [
        _D, ctypes.c_double, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        _D, _D, _D, ctypes.c_int64, ctypes.c_int64, _D,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the oracle library is built (or could be) and loads."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native oracle library is unavailable ({LIB_PATH})")
    return lib


def _f64(a) -> np.ndarray:
    """A contiguous float64 (M, N) numpy array of a numpy array or CPU tensor."""
    if torch.is_tensor(a):
        if a.device.type != "cpu":
            raise ValueError(f"the native oracle runs on the CPU; got a tensor on {a.device}")
        a = a.detach().numpy()
    a = np.ascontiguousarray(a, np.float64)
    if a.ndim != 2:
        raise ValueError(f"the native oracle takes one (M, N) image, got {a.shape}")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def tv_norm_native(x) -> float:
    """Isotropic TV of x with circular backward differences (ops/tv.py::
    tv_norm, utils/TVnorm.m), in float64."""
    x = _f64(x)
    return float(_lib().tv_norm_f64(_ptr(x), x.shape[0], x.shape[1]))


def chambolle_prox_native(
    g,
    lam: float,
    max_iter: int,
    tau: float = 0.249,
    tol: float = 1e-3,
    duals: Optional[Tuple] = None,
):
    """prox_{λ TV}(g) by Chambolle's dual ascent in float64, from zero duals
    or from `duals`; returns (f, px, py, iters, err): tensors for a tensor
    g, numpy arrays otherwise."""
    as_tensor = torch.is_tensor(g)
    lib = _lib()
    g = _f64(g)
    m, n = g.shape
    if duals is None:
        px, py = np.zeros((m, n)), np.zeros((m, n))
    else:
        px, py = (_f64(d).copy() for d in duals)
    f = np.empty((m, n))
    err = ctypes.c_double(0.0)
    iters = lib.chambolle_prox_f64(_ptr(g), float(lam), int(max_iter), float(tau), float(tol),
                                   _ptr(px), _ptr(py), _ptr(f), m, n, ctypes.byref(err))
    if as_tensor:
        f, px, py = (torch.from_numpy(a) for a in (f, px, py))
    return f, px, py, int(iters), float(err.value)
