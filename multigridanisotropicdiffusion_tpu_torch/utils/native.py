"""ctypes bindings to the native CPU kernel library (``native/libmadref.so``
at the root of the repository).

Counterpart of ``multigridanisotropicdiffusion_tpu.utils.native``, a copy
that takes the port's operators and torch tensors (on any device; they are
copied to the host in float64).  The library provides the reference's
*sequential* smoother semantics (lexicographic Gauss-Seidel, one voxel at a
time, hence CPU-only) plus Jacobi, residual and apply kernels in double
precision: an independent oracle for the red-black smoothers and the stencil
application.

The library is built on demand with ``make`` (g++); ``is_available()`` is
False when there is no toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np
import torch

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmadref.so")


@lru_cache(maxsize=1)
def _load():
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    dpp = ctypes.POINTER(dp)
    common = [ctypes.c_int, i64p, ctypes.c_int, i64p, dpp, dp, dp]
    lib.mad_gs_sweep.argtypes = common + [dp]
    lib.mad_wj_sweep.argtypes = common + [ctypes.c_double, dp]
    lib.mad_residual.argtypes = common + [dp]
    lib.mad_apply.argtypes = [ctypes.c_int, i64p, ctypes.c_int, i64p, dpp, dp, dp]
    for f in (lib.mad_gs_sweep, lib.mad_wj_sweep, lib.mad_residual, lib.mad_apply):
        f.restype = None
    return lib


def is_available() -> bool:
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native library {_LIB_PATH} is unavailable")
    return lib


def _as_c(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().double().numpy()
    return np.ascontiguousarray(np.asarray(arr, dtype=np.float64))


def _prep(op):
    """StencilOperator -> (shape arr, offsets arr, coeff planes, plane pointer
    array); the planes must stay referenced while the library reads them."""
    shape = np.asarray(op.shape, dtype=np.int64)
    offsets = np.asarray(op.offsets, dtype=np.int64).reshape(-1)
    planes = [_as_c(c) for c in op.coeffs]
    dp = ctypes.POINTER(ctypes.c_double)
    ptrs = (dp * len(planes))(*[p.ctypes.data_as(dp) for p in planes])
    return shape, offsets, planes, ptrs


def _call(fn, op, x, b=None, *scalars) -> np.ndarray:
    """Run one library function on ``op`` and the fields; returns ``out``."""
    shape, offsets, planes, ptrs = _prep(op)
    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    x = _as_c(x)
    fields = [x] if b is None else [x, _as_c(b)]
    out = np.empty_like(x)
    fn(len(shape), shape.ctypes.data_as(i64p), len(op.offsets),
       offsets.ctypes.data_as(i64p), ptrs, *(f.ctypes.data_as(dp) for f in fields),
       *scalars, out.ctypes.data_as(dp))
    return out


def gs_sweep(op, x, b) -> np.ndarray:
    """Exact lexicographic (C-order) Gauss-Seidel sweep."""
    return _call(_lib().mad_gs_sweep, op, x, b)


def wj_sweep(op, x, b, omega: float = 2.0 / 3.0) -> np.ndarray:
    return _call(_lib().mad_wj_sweep, op, x, b, ctypes.c_double(omega))


def residual(op, x, b) -> np.ndarray:
    return _call(_lib().mad_residual, op, x, b)


def apply_stencil(op, x) -> np.ndarray:
    return _call(_lib().mad_apply, op, x)
