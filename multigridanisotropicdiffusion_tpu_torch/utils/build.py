"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o _build/<name>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o _build/libmadkernels-<hash>.so _build/*.o

The build happens at the first launch, into ``_build/`` beside ``csrc/``,
and again whenever a source's content changes (the library's name carries
a hash of the sources and flags).  Processes that start together (the ranks
of a distributed run) build once: the build holds an exclusive ``flock`` on
``_build/.lock`` (:func:`build_lock`), and whoever comes second finds the
library built.  It needs nothing but the sources in the
package and the CUDA toolkit: no PyTorch headers, no downloads.  ptxas's
per-kernel register report is kept in ``_build/build.log``.  A failed build
raises with nvcc's output.

Pointers and the stream go to the C functions as ``c_void_p``, sizes as
``c_int64``; every entry point returns a ``cudaError_t`` that
:func:`check_launch` turns into an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
_STREAM = _P

#: argument types of each entry point, before the ``_<dtype>`` suffix
SIGNATURES = {
    # planes, x, b, out, nz, ny, nx, planes per block
    # (``ops.cuda_smoothers.launch_geometry``), color, stream
    "mad_stencil_halfsweep": (_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_int, _STREAM),
    # planes, x, b, out, nz, ny, nx, planes per block, stream
    "mad_stencil_residual": (_P, _P, _P, _P, _I, _I, _I, _I, _STREAM),
    # the shard-local forms (B14), same arguments
    "mad_stencil_halfsweep_local": (_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_int,
                                    _STREAM),
    "mad_stencil_residual_local": (_P, _P, _P, _P, _I, _I, _I, _I, _STREAM),
    # the fused red-black sweep: planes, x, b, out, nz, ny, nx, planes per
    # block (``launch_geometry(..., sweep=True)``), stream
    "mad_stencil_sweep": (_P, _P, _P, _P, _I, _I, _I, _I, _STREAM),
    # in, out, batch, in dims (3), out dims (3), starts (3), weights (3), stream
    "mad_restrict3d": (_P, _P, _I) + (_I,) * 6 + (_P,) * 6 + (_STREAM,),
    "mad_prolong3d": (_P, _P, _I) + (_I,) * 6 + (_P,) * 6 + (_STREAM,),
    # e, x, out, batch, coarse dims (3), fine dims (3), starts (3), weights
    # (3), stream
    "mad_prolong_add3d": (_P, _P, _P, _I) + (_I,) * 6 + (_P,) * 6 + (_STREAM,),
    # tensor, out, nz, ny, nx, w2 (3), wd (9), stream
    "mad_assemble_compressed": (_P, _P, _I, _I, _I) + (_D,) * 12 + (_STREAM,),
    # in, out, z in, ny, nx, z out, window base (valid: the stripped taps'
    # shift; edge: -r), compiled radius (0: generic), host weights, host
    # int32 offsets, taps, radius, stream
    "mad_conv_z": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _STREAM),
    # in, out, nz, ny, nx, compiled radius (0: generic), then per axis (y, x)
    # host weights, host int32 offsets, taps, radius; stream
    "mad_conv_yx": (_P, _P, _I, _I, _I, _I) + (_P, _P, _I, _I) * 2 + (_STREAM,),
    # in, out, nz, ny, nx, compiled radius (0: generic), host weights, host
    # int32 offsets, taps, radius, stream
    "mad_conv_y": (_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _STREAM),
    "mad_conv_x": (_P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _STREAM),
    # us, resp, h, nz, ny, nx, facs (6), 2 alpha^2, 2 beta^2, 2 gamma^2,
    # first, stream
    "mad_fd_vesselness": (_P, _P, _P, _I, _I, _I) + (_D,) * 9
    + (ctypes.c_int, _STREAM),
    # us, h, nz, ny, nx, facs (6), stream
    "mad_fd_hessian": (_P, _P, _I, _I, _I) + (_D,) * 6 + (_STREAM,),
    # h, resp, best h, voxels, 2 alpha^2, 2 beta^2, 2 gamma^2, first, stream
    "mad_hessian_vesselness": (_P, _P, _P, _I, _D, _D, _D, ctypes.c_int, _STREAM),
    # resp, h, out, voxels, 1/sensitivity, epsilon - 1, omega - epsilon, stream
    "mad_tensor_assembly": (_P, _P, _P, _I, _D, _D, _D, _STREAM),
    # planes, x, b, out, nz, ny, nx, host tap plan (K - 1, 8) int32
    # (``ops.cuda_smoothers.tap_plan``), K - 1, centre, color, stream
    "mad_stencil_stored_halfsweep": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _I,
                                     ctypes.c_int, _STREAM),
    "mad_stencil_stored_residual": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _I,
                                    _STREAM),
    # planes, x, b, out, ny, nx, color, stream
    "mad_stencil2d_compressed_halfsweep": (_P, _P, _P, _P, _I, _I, ctypes.c_int,
                                           _STREAM),
    "mad_stencil2d_compressed_residual": (_P, _P, _P, _P, _I, _I, _STREAM),
    # planes, x, b, out, ny, nx, host tap plan (K - 1, 8) int32, K - 1,
    # centre, color, stream
    "mad_stencil2d_stored_halfsweep": (_P, _P, _P, _P, _I, _I, _P, _I, _I,
                                       ctypes.c_int, _STREAM),
    "mad_stencil2d_stored_residual": (_P, _P, _P, _P, _I, _I, _P, _I, _I,
                                      _STREAM),
    # planes, out, planes in, fine dims (3), coarse dims (3), host fine table
    # (A^3 int32), A, host output map (O^3 int32), O, planes out, axis
    # starts (int32), axis weights (float32), host interior rows (float32),
    # host interior runs (6 int32), coarse z planes per block, the form's
    # code, stream (``ops.cuda_galerkin.product_plan``)
    "mad_galerkin_product": (_P, _P, _I) + (_I,) * 6 + (_P, _I, _P, _I, _I, _P, _P, _P, _P,
                                                         _I, _I, _STREAM),
}

#: entry points built for some storage types only (the rest: every type of
#: :data:`DTYPE_SUFFIX`)
ENTRY_DTYPES = {
    "mad_galerkin_product": (torch.float32, torch.float64),
}

DTYPE_SUFFIX = {
    torch.float32: "f32",
    torch.bfloat16: "bf16",
    torch.float64: "f64",
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmadkernels-{source_hash()}.so"


@contextlib.contextmanager
def build_lock(directory: Path | None = None):
    """Hold the exclusive inter-process lock of the build directory
    (``flock`` on its ``.lock`` file, released when the block ends or the
    process dies)."""
    directory = BUILD_DIR if directory is None else Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build() -> Path:
    """Compile the library unless the current sources' build exists: one
    ``nvcc -c`` per source, run in parallel, then one link, under
    :func:`build_lock`."""
    out = library_path()
    if out.exists():
        return out
    with build_lock():
        if out.exists():  # another process built it while we waited
            return out
        return _build(out)


def _build(out: Path) -> Path:
    tag = f"{source_hash()}.{os.getpid()}"
    nvcc = find_nvcc()
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed = [], False
    for cmd, _, proc in jobs:
        log.append(" ".join(cmd) + "\n" + proc.communicate()[0])
        failed = failed or proc.returncode != 0
    objs = [obj for _, obj, _ in jobs]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        failed = proc.returncode != 0
    for obj in objs:
        obj.unlink(missing_ok=True)
    text = "".join(log)
    (BUILD_DIR / "build.log").write_text(text)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declares every entry
    point's argument and return types."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                for dtype in ENTRY_DTYPES.get(name, DTYPE_SUFFIX):
                    fn = getattr(lib, f"{name}_{DTYPE_SUFFIX[dtype]}")
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
            lib.mad_error_string.argtypes = [ctypes.c_int]
            lib.mad_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def kernel(name: str, dtype: torch.dtype):
    """The C entry point ``name`` for storage ``dtype``."""
    if dtype not in ENTRY_DTYPES.get(name, DTYPE_SUFFIX):
        raise TypeError(f"{name}: no kernel for dtype {dtype}")
    return getattr(load_library(), f"{name}_{DTYPE_SUFFIX[dtype]}")


def check_launch(err: int, name: str) -> None:
    if err != 0:
        msg = load_library().mad_error_string(err).decode()
        raise RuntimeError(f"{name}: launch failed with CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one device
    and one kernel dtype."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: mixed dtypes {first.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if first.dtype not in DTYPE_SUFFIX:
        raise TypeError(f"{name}: no kernel for dtype {first.dtype}")
