"""The stencil kernels: red-black Gauss-Seidel half-sweeps and the residual
on every operator that has one (``csrc/stencil_compressed.cu``,
``csrc/stencil_stored.cu`` with the contraction of
``csrc/stencil_stored.cuh``, ``csrc/stencil_2d.cu``; the 3D kernels march
the tiles of ``csrc/stencil_tile.cuh``).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_smoothers``:
:func:`kernel_takes` is its ``pallas_compatible``, and one set of entry
points (:func:`halfsweep`, :func:`rbgs_sweep`, :func:`cuda_residual` and the
shard-local :func:`halfsweep_local`, :func:`cuda_residual_local`) serves
every operator, dispatching on its form (:data:`ENTRIES`):

* ``compressed`` (B1/B2): the 3D compressed DCA operator's ten planes, with
  the run of z planes of its launch geometry (:func:`launch_geometry`: a
  block owns ``TILE_Y[dtype]`` rows x ``TILE_X`` columns and marches down a
  run of z planes, a lane owning ``VEC`` consecutive cells of a row).
  :func:`rbgs_sweep` runs its whole sweep as one launch (``sweep``, B17),
  which reads the planes and b once where two half-sweeps read them twice;
* ``stored`` (B12): a 3D stored operator of radius 1 or 2 (the 19-plane
  stored DCA operator, collapsed Galerkin levels of 27 planes, exact ones of
  up to 125), its ``(K, Z, Y, X)`` planes in their own order with the
  host's tap plan (:func:`tap_plan`) and the centre index;
* ``2d_compressed`` and ``2d_stored`` (B13, the JAX package's
  ``_build_stencil_pass_2d``): the 2D compressed operator's six planes, and
  a 2D stored operator of radius 1, B12's kernel on one plane.

The shard-local forms (B14; the JAX package's ``local_mask=True``) run on
one rank's block of the distributed solve (:mod:`..parallel.halo`), 3D
radius-1 operators only: they drop every term that reaches across the
block's border (:func:`mask_local_shells`), which the halo code restores on
the boundary slabs.  The compressed operator has kernels of their own; a
stored one runs B12's kernel, which reads every neighbour outside the array
as 0: the masking, up to the sign of an exact zero.

Each entry point takes the plain PyTorch version (``*_plain``) for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.  Storage may be
float32, bfloat16 or float64; 16-bit storage computes in float32 and rounds
once at the store, in the kernels and the plain versions alike.  The
kernels round every product, sum and the division on their own, in the
plain versions' order, with x zero outside the grid: their outputs are the
plain versions' bytes (the shard-local forms: their values), B13's
compressed form aside, which keeps tolerances.

:data:`launches` counts kernel launches by ``(form, pass)``, the pass one of
``halfsweep``, ``sweep`` (the compressed 3D form's fused sweep), ``residual``,
``halfsweep_local`` and ``residual_local``.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..core.stencil import StencilOperator, compute_dtype
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .compressed import CompressedDCAOperator
from .smoothers import gs_halfsweep

#: kernel launches by ``(form, pass)``, e.g. ``("stored", "halfsweep_local")``
launches: collections.Counter = collections.Counter()

#: the C entry points' prefix of each form: ``<prefix>_halfsweep``,
#: ``<prefix>_residual`` and, for the compressed form, their ``_local``
#: kernels (a stored operator's shard-local form is B12's kernel)
ENTRIES = {
    "compressed": "mad_stencil",
    "stored": "mad_stencil_stored",
    "2d_compressed": "mad_stencil2d_compressed",
    "2d_stored": "mad_stencil2d_stored",
}

#: the kernels' tile (``csrc/stencil_tile.cuh``): a block owns 128 columns
#: of ``TILE_Y[dtype]`` rows; a lane owns ``VEC`` consecutive cells; the
#: staged x rows keep the column phases (column mod ``VEC``) apart,
#: ``PHASE`` values each, ``ROW`` values a row, the tile's first column at
#: phase 0, index 1
TILE_X, VEC, PHASE = 128, 4, 34
ROW = VEC * PHASE
TILE_Y = {torch.float32: 8, torch.bfloat16: 8, torch.float64: 4}
#: the stored kernels' tap plan holds at most this many planes (radius 2 in 3D)
MAX_OFFSETS = 125
#: blocks a compressed launch aims at: short runs of planes make many
#: blocks, so the last wave of blocks on the card's 132 SMs is a small share
#: of the launch (a 512^3 bf16 half-sweep took 5% longer in 2048 blocks;
#: PERF.md), and the coarse levels fill the card too
TARGET_BLOCKS = 16384
#: planes per block: at least MIN_RUN (the ring of 4 planes stages 2 more
#: than a run computes), at most MAX_RUN
MIN_RUN, MAX_RUN = 4, 64
#: blocks a launch may have along y (``ceil(Y / TILE_Y)``) and along z
MAX_GRID_Y = 65535
MAX_GRID_Z = 65535
#: the fused sweep's plan (one block an SM at a time): its red pass also
#: covers the planes before and after a block's run, so runs are long (the
#: two extra planes a small share of the reads) and blocks few, about one
#: wave where the field allows: on an H100 a 512^3 sweep took 6% less time
#: in runs of 256 planes than of 32, a 128^3 one 15% less in runs of 16 than
#: of 8 (PERF.md)
SWEEP_TARGET_BLOCKS = 128
SWEEP_MIN_RUN, SWEEP_MAX_RUN = 8, 256


def kernel_takes(op, max_radius: int = 2) -> bool:
    """Whether ``op`` has a stencil kernel: the counterpart of the JAX
    package's ``pallas_compatible``.  The compressed operator in 2D or 3D;
    a 3D stored operator of radius 1 ... ``max_radius`` (stored DCA and
    collapsed Galerkin levels are radius 1, exact Galerkin levels reach 2);
    a 2D stored operator of radius 1.  The shard-local forms take 3D
    operators of ``max_radius=1``."""
    if isinstance(op, CompressedDCAOperator):
        return op.ndim in (2, 3)
    if not isinstance(op, StencilOperator):
        return False
    ndim, radius, _ = layout(op.offsets)
    if ndim == 3:
        return 1 <= radius <= max_radius
    return ndim == 2 and radius == 1


# ---------------------------------------------------------------------------
# the plain versions: what the entry points run for a CPU tensor, and the
# references the kernels are held to
# ---------------------------------------------------------------------------


def halfsweep_plain(op, x: torch.Tensor, b: torch.Tensor, color: int) -> torch.Tensor:
    """Plain version of the half-sweep kernels (zero padding at the
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


def _shells(shape, device):
    """Per dimension, ``(not on the first shell, not on the last shell)``
    as broadcastable boolean tensors."""
    out = []
    for d, n in enumerate(shape):
        view = [1] * len(shape)
        view[d] = n
        ids = torch.arange(n, device=device).reshape(view)
        out.append((ids > 0, ids < n - 1))
    return out


def mask_local_shells(op):
    """The plain form of the JAX package's shard-local masking.  The
    compressed operator (``_mask_local_shells``): ``fp_d`` zeroed on the
    last shell of dimension d, ``fm_d`` on the first, each mixed plane as a
    whole on both shells of both of its dimensions.  A stored operator of
    radius 1 (``_mask_local_shells_stored``): each coefficient zeroed on the
    block shells its offset crosses."""
    if isinstance(op, CompressedDCAOperator):
        ndim = op.ndim
        shells = _shells(op.shape, op.planes.device)
        inner = [lo & hi for lo, hi in shells]
        masks = []
        for d in range(ndim):
            masks += [shells[d][1], shells[d][0]]
        for d in range(ndim):
            for d2 in range(d + 1, ndim):
                masks.append(inner[d] & inner[d2])
        zero = torch.zeros((), dtype=op.planes.dtype, device=op.planes.device)
        planes = [torch.where(m, p, zero) for m, p in zip(masks, op.planes[:-1])]
        return CompressedDCAOperator(torch.stack(planes + [op.planes[-1]]), ndim)
    if op.radius != 1:
        raise ValueError(f"the shard-local form takes radius-1 operators, got {op!r}")
    shells = _shells(op.shape, op.coeffs.device)
    zero = torch.zeros((), dtype=op.dtype, device=op.coeffs.device)
    planes = []
    for plane, off in zip(op.coeffs, op.offsets):
        keep = None
        for d, o in enumerate(off):
            if o:
                cond = shells[d][1] if o > 0 else shells[d][0]
                keep = cond if keep is None else keep & cond
        planes.append(plane if keep is None else torch.where(keep, plane, zero))
    return StencilOperator(torch.stack(planes), op.offsets)


def halfsweep_local_plain(op, x: torch.Tensor, b: torch.Tensor, color: int) -> torch.Tensor:
    """Plain version of the shard-local half-sweep."""
    return gs_halfsweep(mask_local_shells(op), x, b, color)


def residual_local_plain(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the shard-local residual."""
    return residual_plain(mask_local_shells(op), x, b)


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def launch_geometry(shape, dtype: torch.dtype,
                    sweep: bool = False) -> tuple[int, tuple[int, int, int]]:
    """``(planes per block, grid)`` of a compressed launch on a ``(Z, Y,
    X)`` field: one block per ``TILE_Y[dtype]`` rows x ``TILE_X`` columns x
    run of z planes, the runs as long as about ``TARGET_BLOCKS`` blocks in
    all make them, within ``[MIN_RUN, MAX_RUN]`` (and at most ``Z``), and
    longer where ``Z`` would need more than ``MAX_GRID_Z`` runs.  With
    ``sweep``, the fused sweep's: ``SWEEP_TARGET_BLOCKS`` within
    ``[SWEEP_MIN_RUN, SWEEP_MAX_RUN]``."""
    target, lo, hi = ((SWEEP_TARGET_BLOCKS, SWEEP_MIN_RUN, SWEEP_MAX_RUN) if sweep
                      else (TARGET_BLOCKS, MIN_RUN, MAX_RUN))
    nz, ny, nx = (int(n) for n in shape)
    gx, gy = -(-nx // TILE_X), -(-ny // TILE_Y[dtype])
    zrun = min(max(-(-nz * gx * gy // target), lo), hi)
    if -(-nz // zrun) > MAX_GRID_Z:
        zrun = -(-nz // MAX_GRID_Z)
    zrun = max(min(zrun, nz), 1)
    return zrun, (gx, gy, -(-nz // zrun))


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
    """The stored kernels' tap plan of an offset table: one C-contiguous
    int32 row per non-centre offset, in the operator's order: plane index,
    ``dz``, ``dy``, ``dx`` (``dz`` 0 in 2D) and :func:`ring_offset` of each
    of a lane's ``VEC`` cells.  Cached per table (every level of a hierarchy
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


def _form(op) -> str:
    """The key of ``op``'s kernel in :data:`ENTRIES`."""
    kind = "compressed" if isinstance(op, CompressedDCAOperator) else "stored"
    return kind if op.ndim == 3 else f"2d_{kind}"


def _check(name: str, op, x: torch.Tensor, b: torch.Tensor, local: bool = False) -> str:
    """Raise unless ``op``'s kernel (``local``: its shard-local form) takes
    ``x`` and ``b``; return ``op``'s form."""
    if not kernel_takes(op, 1 if local else 2) or local and op.ndim != 3:
        what = "the shard-local form takes 3D radius-1 operators" if local else \
            "no stencil kernel takes this operator"
        raise ValueError(f"{name}: {what}, got {op!r}")
    form = _form(op)
    if form.endswith("stored"):
        if len(op.offsets) > MAX_OFFSETS:
            raise ValueError(f"{name}: {len(op.offsets)} planes exceed {MAX_OFFSETS}")
        require_cuda(name, op.coeffs, x, b)
    else:
        require_cuda(name, op.planes, x, b)
    if tuple(x.shape) != op.shape or tuple(b.shape) != op.shape:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} / b {tuple(b.shape)} != operator {op.shape}"
        )
    if form == "2d_compressed":  # blocks of 8 rows in every dtype
        if (op.shape[0] + 7) // 8 > MAX_GRID_Y:
            raise ValueError(f"{name}: grid of {op.shape} exceeds the launch limits")
    else:
        check_grid(name, op.shape, x.dtype)
    return form


def _launch(name: str, op, x: torch.Tensor, b: torch.Tensor, *color) -> torch.Tensor:
    """Pass ``name`` of ``op``'s kernel, out of place: the operator's planes,
    x, b, out, the shape, the form's plan (the compressed 3D form: planes
    per block; a stored form: tap plan, its length, centre index), the
    colour of a half-sweep, the stream."""
    form = _check(name, op, x, b, local=name.endswith("_local"))
    if form.endswith("compressed"):
        entry, planes = f"{ENTRIES[form]}_{name}", op.planes
        plan = ((launch_geometry(op.shape, x.dtype, name == "sweep")[0],)
                if form == "compressed" else ())
    else:
        taps = tap_plan(op.offsets)
        entry = f"{ENTRIES[form]}_{name.removesuffix('_local')}"
        planes, plan = op.coeffs, (taps.ctypes.data, len(taps), layout(op.offsets)[2])
    out = torch.empty_like(x)
    err = kernel(entry, x.dtype)(
        planes.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(), *op.shape,
        *plan, *color, stream_of(x),
    )
    check_launch(err, entry)
    launches[form, name] += 1
    return out


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def halfsweep(op, x: torch.Tensor, b: torch.Tensor, color: int) -> torch.Tensor:
    """One half-sweep updating the cells of parity ``color`` (0 = red, even
    index sum), out of place."""
    if x.device.type == "cpu":
        return halfsweep_plain(op, x, b, color)
    return _launch("halfsweep", op, x, b, int(color))


def rbgs_sweep(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep, red then black, out of place: on
    the 3D compressed operator one launch, bit for bit the two half-sweeps;
    on the other forms the two half-sweeps."""
    if x.device.type == "cpu":
        return rbgs_sweep_plain(op, x, b)
    if _form(op) == "compressed":
        return _launch("sweep", op, x, b)
    for color in (0, 1):
        x = halfsweep(op, x, b, color)
    return x


def cuda_residual(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Residual ``r = b - A x``."""
    if x.device.type == "cpu":
        return residual_plain(op, x, b)
    return _launch("residual", op, x, b)


def halfsweep_local(op, x: torch.Tensor, b: torch.Tensor, color: int) -> torch.Tensor:
    """The half-sweep of parity ``color`` (local index sum) on a block of a
    3D radius-1 operator, every term across the block's border dropped."""
    if x.device.type == "cpu":
        return halfsweep_local_plain(op, x, b, color)
    return _launch("halfsweep_local", op, x, b, int(color))


def cuda_residual_local(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The residual on a block of a 3D radius-1 operator, every term across
    the block's border dropped."""
    if x.device.type == "cpu":
        return residual_local_plain(op, x, b)
    return _launch("residual_local", op, x, b)
