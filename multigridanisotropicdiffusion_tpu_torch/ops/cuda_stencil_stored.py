"""The stencil kernel on 3D stored operators: red-black Gauss-Seidel
half-sweeps and the residual (``csrc/stencil_stored.cu``, the contraction
in ``csrc/stencil_stored.cuh``, the tile march in ``csrc/stencil_tile.cuh``).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_smoothers``
in its stored form (``_build_stencil_pass`` with ``offsets`` given): the
19-plane stored DCA operator, collapsed Galerkin levels (27 planes) and
exact Galerkin levels (radius 2, up to 125 planes), in any order.  The
kernel takes the operator's ``(K, Z, Y, X)`` planes in their own order
with the host's tap plan (:func:`tap_plan`) and the centre index as launch
arguments.  Each wrapper takes the plain PyTorch version for a CPU tensor;
for a CUDA tensor it launches the kernel or raises.  Storage may be
float32, bfloat16 or float64; 16-bit storage computes in float32 and rounds
once at the store.  Every product and sum rounds on its own, in the plain
version's order, so a kernel's output is its plain version's bytes.

The shard-local form of radius-1 operators (B14 stored, the JAX package's
``local_mask=True`` with ``offsets``; ``halfsweep_local``,
``cuda_residual_local``) needs no kernel of its own: the kernel reads every
neighbour outside the array as 0, which on a rank's block is
``_mask_local_shells_stored`` (:func:`mask_local_shells_stored`, the plain
versions' masking) up to the sign of an exact zero.  It runs the same
kernel under its own launch counters.

``halfsweep.launches``, ``cuda_residual.launches``,
``halfsweep_local.launches`` and ``cuda_residual_local.launches`` count
kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.stencil import StencilOperator, compute_dtype
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .smoothers import gs_halfsweep

#: the kernel's tap plan holds at most this many planes (radius 2 in 3D)
MAX_OFFSETS = 125


def halfsweep_plain(op: StencilOperator, x: torch.Tensor, b: torch.Tensor,
                    color: int) -> torch.Tensor:
    """Plain version of the half-sweep kernel (zero padding at the
    borders)."""
    return gs_halfsweep(op, x, b, color)


def residual_plain(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the residual kernels: ``b - diag * x - offdiag(A) x``
    in the compute dtype, rounded once."""
    cd = compute_dtype(x.dtype)
    xc = x.to(cd)
    return (b.to(cd) - op.diag.to(cd) * xc - op.offdiag_apply(xc)).to(x.dtype)


def rbgs_sweep_plain(op, x, b):
    for color in (0, 1):
        x = halfsweep_plain(op, x, b, color)
    return x


#: the kernel's tile (``csrc/stencil_tile.cuh``, the compressed operator's
#: kernel's too, :mod:`.cuda_smoothers`): a block owns 128
#: columns of ``TILE_Y[dtype]`` rows; a lane owns ``VEC`` consecutive cells;
#: the staged x rows keep the column phases (column mod ``VEC``) apart,
#: ``PHASE`` values each, ``ROW`` values a row, the tile's first column at
#: phase 0, index 1
TILE_X, VEC, PHASE = 128, 4, 34
ROW = VEC * PHASE
TILE_Y = {torch.float32: 8, torch.bfloat16: 8, torch.float64: 4}
#: the y extent of one launch: ``ceil(Y / TILE_Y)`` blocks at most
MAX_GRID_Y = 65535


def ring_offset(dy: int, dx: int, j: int) -> int:
    """Offset, in the staged x tile, of the neighbour ``(dy, dx)`` of a
    lane's cell ``j``, from the lane's base (its row, index ``lane`` of
    phase 0; the cell itself is at phase ``j``, one index further): column
    ``j + dx`` lies at phase ``(j + dx) mod VEC``, one index further per
    ``VEC`` columns."""
    q = j + dx
    return dy * ROW + (q % VEC) * PHASE + 1 + q // VEC


@functools.lru_cache(maxsize=256)
def tap_plan(offsets) -> np.ndarray:
    """The kernels' tap plan of an offset table: one C-contiguous int32 row
    per non-centre offset, in the operator's order: plane index, ``dz``,
    ``dy``, ``dx`` (``dz`` 0 in 2D) and :func:`ring_offset` of each of a
    lane's ``VEC`` cells.  Cached per table (every level of a hierarchy
    shares a few); the launchers check each row against their geometry."""
    rows = []
    for t, off in enumerate(offsets):
        dz, dy, dx = (0,) * (3 - len(off)) + tuple(int(o) for o in off)
        if (dz, dy, dx) == (0, 0, 0):
            continue
        rows.append([t, dz, dy, dx] + [ring_offset(dy, dx, j) for j in range(VEC)])
    plan = np.ascontiguousarray(np.asarray(rows, dtype=np.int32).reshape(-1, 4 + VEC))
    plan.flags.writeable = False  # shared by every caller of the cache
    return plan


@functools.lru_cache(maxsize=256)
def layout(offsets) -> tuple[int, int, int]:
    """``(ndim, radius, centre index)`` of an offset table, cached per table:
    the operator's ``radius`` walks every offset, which every launch of a
    level would pay again."""
    ndim = len(offsets[0])
    return ndim, max(abs(o) for off in offsets for o in off), offsets.index((0,) * ndim)


def check_grid(name: str, shape, dtype: torch.dtype) -> None:
    """Raise if a ``(..., Y, X)`` field is taller than one launch takes."""
    if -(-shape[-2] // TILE_Y[dtype]) > MAX_GRID_Y:
        raise ValueError(f"{name}: {shape[-2]} rows exceed the launch limit of "
                         f"{MAX_GRID_Y * TILE_Y[dtype]} for {dtype}")


def _check(name: str, op, x: torch.Tensor, b: torch.Tensor) -> None:
    ndim, radius, _ = layout(op.offsets) if isinstance(op, StencilOperator) else (0, 0, 0)
    if ndim != 3 or not 1 <= radius <= 2:
        raise ValueError(f"{name}: needs a 3D stored operator of radius 1 or 2, "
                         f"got {op!r}")
    if len(op.offsets) > MAX_OFFSETS:
        raise ValueError(f"{name}: {len(op.offsets)} planes exceed {MAX_OFFSETS}")
    require_cuda(name, op.coeffs, x, b)
    if tuple(x.shape) != op.shape or tuple(b.shape) != op.shape:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} / b {tuple(b.shape)} != operator {op.shape}"
        )
    check_grid(name, op.shape, x.dtype)


def _launch(entry: str, op, x, b, *color) -> torch.Tensor:
    out = torch.empty_like(x)
    plan = tap_plan(op.offsets)
    err = kernel(entry, x.dtype)(
        op.coeffs.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(),
        *op.shape, plan.ctypes.data, len(plan), layout(op.offsets)[2],
        *color, stream_of(x),
    )
    check_launch(err, entry)
    return out


def halfsweep(op: StencilOperator, x: torch.Tensor, b: torch.Tensor,
              color: int) -> torch.Tensor:
    """One half-sweep updating the cells of parity ``color`` (0 = red, even
    index sum), out of place."""
    if x.device.type == "cpu":
        return halfsweep_plain(op, x, b, color)
    _check("halfsweep", op, x, b)
    out = _launch("mad_stencil_stored_halfsweep", op, x, b, int(color))
    halfsweep.launches += 1
    return out


halfsweep.launches = 0


def rbgs_sweep(op: StencilOperator, x: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep: red half-sweep, then black."""
    for color in (0, 1):
        x = halfsweep(op, x, b, color)
    return x


def cuda_residual(op: StencilOperator, x: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Residual ``r = b - A x``."""
    if x.device.type == "cpu":
        return residual_plain(op, x, b)
    _check("cuda_residual", op, x, b)
    out = _launch("mad_stencil_stored_residual", op, x, b)
    cuda_residual.launches += 1
    return out


cuda_residual.launches = 0


# ---------------------------------------------------------------------------
# the shard-local form (B14 stored): the same kernel
# ---------------------------------------------------------------------------


def mask_local_shells_stored(op: StencilOperator) -> StencilOperator:
    """The plain form of ``_mask_local_shells_stored``: each coefficient
    zeroed on the block shells its offset crosses (radius 1)."""
    if op.radius != 1:
        raise ValueError(f"the shard-local form takes radius-1 operators, got {op!r}")
    ids = []
    for d, n in enumerate(op.shape):
        view = [1] * op.ndim
        view[d] = n
        ids.append(torch.arange(n, device=op.coeffs.device).reshape(view))
    zero = torch.zeros((), dtype=op.dtype, device=op.coeffs.device)
    planes = []
    for plane, off in zip(op.coeffs, op.offsets):
        keep = None
        for d, o in enumerate(off):
            if o:
                cond = ids[d] < op.shape[d] - 1 if o > 0 else ids[d] > 0
                keep = cond if keep is None else keep & cond
        planes.append(plane if keep is None else torch.where(keep, plane, zero))
    return StencilOperator(torch.stack(planes), op.offsets)


def halfsweep_local_plain(op: StencilOperator, x: torch.Tensor, b: torch.Tensor,
                          color: int) -> torch.Tensor:
    return gs_halfsweep(mask_local_shells_stored(op), x, b, color)


def residual_local_plain(op: StencilOperator, x: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    return residual_plain(mask_local_shells_stored(op), x, b)


def _check_local(name, op, x, b):
    _check(name, op, x, b)
    if layout(op.offsets)[1] != 1:
        raise ValueError(f"{name}: the shard-local form takes radius-1 operators")


def halfsweep_local(op: StencilOperator, x: torch.Tensor, b: torch.Tensor,
                    color: int) -> torch.Tensor:
    """The half-sweep of parity ``color`` (local index sum) on a block of a
    radius-1 operator, every term across the block's border dropped."""
    if x.device.type == "cpu":
        return halfsweep_local_plain(op, x, b, color)
    _check_local("halfsweep_local", op, x, b)
    out = _launch("mad_stencil_stored_halfsweep", op, x, b, int(color))
    halfsweep_local.launches += 1
    return out


halfsweep_local.launches = 0


def cuda_residual_local(op: StencilOperator, x: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The residual on a block of a radius-1 operator, every term across
    the block's border dropped."""
    if x.device.type == "cpu":
        return residual_local_plain(op, x, b)
    _check_local("cuda_residual_local", op, x, b)
    out = _launch("mad_stencil_stored_residual", op, x, b)
    cuda_residual_local.launches += 1
    return out


cuda_residual_local.launches = 0
