"""The stencil kernel on the 3D compressed DCA operator: red-black
Gauss-Seidel half-sweeps and the residual (``csrc/stencil_compressed.cu``).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_smoothers``
(its compressed 3D form: ``pallas_rbgs_halfsweep``, ``pallas_rbgs_sweep``,
``pallas_residual``).  Each wrapper takes the plain PyTorch version for a
CPU tensor; for a CUDA tensor it launches the kernel or raises.  Storage may
be float32, bfloat16 or float64; 16-bit storage computes in float32 and
rounds once at the store, in the kernel and in the plain versions alike.

The shard-local forms (B14, ``halfsweep_local``, ``cuda_residual_local``;
the JAX package's ``local_mask=True``) run on one rank's block of the
distributed solve (:mod:`..parallel.halo`): they zero every coefficient that
reaches across the block's border (:func:`mask_local_shells`), which the
halo code then restores on the boundary slabs.  Their plain versions mask
the planes, then run the plain half-sweep or residual.

The kernel (``csrc/stencil_compressed.cu`` over ``csrc/stencil_tile.cuh``,
the tile march B12 uses too) rounds every product, sum and the division on
its own, in the plain versions' order, with x zero outside the grid: its
outputs are the plain versions' bytes (the shard-local forms: their values).
Its launch geometry is this module's (:func:`launch_geometry`): a block owns
``TILE_Y[dtype]`` rows x ``TILE_X`` columns (the tile of
:mod:`.cuda_stencil_stored`) and marches down a run of z planes, a lane
owning 4 consecutive cells of a row.

``halfsweep.launches``, ``cuda_residual.launches``,
``halfsweep_local.launches`` and ``cuda_residual_local.launches`` count
kernel launches.
"""

from __future__ import annotations

import functools

import torch

from ..core.stencil import compute_dtype
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .compressed import CompressedDCAOperator
from .cuda_stencil_stored import TILE_X, TILE_Y, check_grid
from .smoothers import gs_halfsweep

#: blocks a launch aims at: short runs of planes make many blocks, so the
#: last wave of blocks on the card's 132 SMs is a small share of the launch
#: (a 512^3 bf16 half-sweep took 5% longer in 2048 blocks; PERF.md), and the
#: coarse levels fill the card too
TARGET_BLOCKS = 16384
#: planes per block: at least MIN_RUN (the ring of 4 planes stages 2 more
#: than a run computes), at most MAX_RUN
MIN_RUN, MAX_RUN = 4, 64
#: blocks a launch may have along z (along y: ``check_grid``)
MAX_GRID_Z = 65535


def halfsweep_plain(op: CompressedDCAOperator, x: torch.Tensor, b: torch.Tensor,
                    color: int) -> torch.Tensor:
    """Plain version of the half-sweep kernel."""
    return gs_halfsweep(op, x, b, color)


def residual_plain(op: CompressedDCAOperator, x: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Plain version of the residual kernel: ``b - diag * x - offdiag(A) x``."""
    cd = compute_dtype(x.dtype)
    xc = x.to(cd)
    return (b.to(cd) - op.diag.to(cd) * xc - op.offdiag_apply(xc)).to(x.dtype)


def rbgs_sweep_plain(op, x, b):
    for color in (0, 1):
        x = halfsweep_plain(op, x, b, color)
    return x


@functools.lru_cache(maxsize=256)
def launch_geometry(shape, dtype: torch.dtype) -> tuple[int, tuple[int, int, int]]:
    """``(planes per block, grid)`` of a launch on a ``(Z, Y, X)`` field:
    one block per ``TILE_Y[dtype]`` rows x ``TILE_X`` columns x run of z
    planes, the runs as long as about ``TARGET_BLOCKS`` blocks in all make
    them, within ``[MIN_RUN, MAX_RUN]`` (and at most ``Z``), and longer
    where ``Z`` would need more than ``MAX_GRID_Z`` runs."""
    nz, ny, nx = (int(n) for n in shape)
    gx, gy = -(-nx // TILE_X), -(-ny // TILE_Y[dtype])
    zrun = min(max(-(-nz * gx * gy // TARGET_BLOCKS), MIN_RUN), MAX_RUN)
    if -(-nz // zrun) > MAX_GRID_Z:
        zrun = -(-nz // MAX_GRID_Z)
    zrun = max(min(zrun, nz), 1)
    return zrun, (gx, gy, -(-nz // zrun))


def _check(name: str, op, x: torch.Tensor, b: torch.Tensor) -> None:
    if not isinstance(op, CompressedDCAOperator) or op.ndim != 3:
        raise ValueError(f"{name}: needs a 3D CompressedDCAOperator, got {op!r}")
    require_cuda(name, op.planes, x, b)
    if tuple(x.shape) != op.shape or tuple(b.shape) != op.shape:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} / b {tuple(b.shape)} != operator {op.shape}"
        )
    check_grid(name, op.shape, x.dtype)


def _launch(entry: str, op, x, b, *color) -> torch.Tensor:
    out = torch.empty_like(x)
    err = kernel(entry, x.dtype)(
        op.planes.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(),
        *op.shape, launch_geometry(op.shape, x.dtype)[0], *color, stream_of(x),
    )
    check_launch(err, entry)
    return out


def halfsweep(op: CompressedDCAOperator, x: torch.Tensor, b: torch.Tensor,
              color: int) -> torch.Tensor:
    """One half-sweep updating the cells of parity ``color`` (0 = red, even
    index sum), out of place."""
    if x.device.type == "cpu":
        return halfsweep_plain(op, x, b, color)
    _check("halfsweep", op, x, b)
    out = _launch("mad_stencil_halfsweep", op, x, b, int(color))
    halfsweep.launches += 1
    return out


halfsweep.launches = 0


def rbgs_sweep(op: CompressedDCAOperator, x: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep: red half-sweep, then black."""
    for color in (0, 1):
        x = halfsweep(op, x, b, color)
    return x


def cuda_residual(op: CompressedDCAOperator, x: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Residual ``r = b - A x``."""
    if x.device.type == "cpu":
        return residual_plain(op, x, b)
    _check("cuda_residual", op, x, b)
    out = _launch("mad_stencil_residual", op, x, b)
    cuda_residual.launches += 1
    return out


cuda_residual.launches = 0


# ---------------------------------------------------------------------------
# the shard-local form (B14)
# ---------------------------------------------------------------------------


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


def mask_local_shells(op: CompressedDCAOperator) -> CompressedDCAOperator:
    """The plain form of ``_mask_local_shells``: ``fp_d`` zeroed on the last
    shell of dimension d, ``fm_d`` on the first, each mixed plane as a whole
    on both shells of both of its dimensions."""
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


def halfsweep_local_plain(op: CompressedDCAOperator, x: torch.Tensor, b: torch.Tensor,
                          color: int) -> torch.Tensor:
    """Plain version of the shard-local half-sweep kernel."""
    return gs_halfsweep(mask_local_shells(op), x, b, color)


def residual_local_plain(op: CompressedDCAOperator, x: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain version of the shard-local residual kernel."""
    return residual_plain(mask_local_shells(op), x, b)


def halfsweep_local(op: CompressedDCAOperator, x: torch.Tensor, b: torch.Tensor,
                    color: int) -> torch.Tensor:
    """The half-sweep of parity ``color`` (local index sum) on a block, with
    every term across the block's border dropped."""
    if x.device.type == "cpu":
        return halfsweep_local_plain(op, x, b, color)
    _check("halfsweep_local", op, x, b)
    out = _launch("mad_stencil_halfsweep_local", op, x, b, int(color))
    halfsweep_local.launches += 1
    return out


halfsweep_local.launches = 0


def cuda_residual_local(op: CompressedDCAOperator, x: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The residual on a block, with every term across its border dropped."""
    if x.device.type == "cpu":
        return residual_local_plain(op, x, b)
    _check("cuda_residual_local", op, x, b)
    out = _launch("mad_stencil_residual_local", op, x, b)
    cuda_residual_local.launches += 1
    return out


cuda_residual_local.launches = 0
