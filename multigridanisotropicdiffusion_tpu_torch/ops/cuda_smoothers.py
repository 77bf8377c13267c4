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

``halfsweep.launches``, ``cuda_residual.launches``,
``halfsweep_local.launches`` and ``cuda_residual_local.launches`` count
kernel launches.
"""

from __future__ import annotations

import torch

from ..core.stencil import compute_dtype
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .compressed import CompressedDCAOperator
from .smoothers import gs_halfsweep


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


def _check(name: str, op, x: torch.Tensor, b: torch.Tensor) -> None:
    if not isinstance(op, CompressedDCAOperator) or op.ndim != 3:
        raise ValueError(f"{name}: needs a 3D CompressedDCAOperator, got {op!r}")
    require_cuda(name, op.planes, x, b)
    if tuple(x.shape) != op.shape or tuple(b.shape) != op.shape:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} / b {tuple(b.shape)} != operator {op.shape}"
        )
    nz, ny, _ = op.shape
    if nz > 65535 or (ny + 7) // 8 > 65535:
        raise ValueError(f"{name}: grid of {op.shape} exceeds the launch limits")


def halfsweep(op: CompressedDCAOperator, x: torch.Tensor, b: torch.Tensor,
              color: int) -> torch.Tensor:
    """One half-sweep updating the cells of parity ``color`` (0 = red, even
    index sum), out of place."""
    if x.device.type == "cpu":
        return halfsweep_plain(op, x, b, color)
    _check("halfsweep", op, x, b)
    out = torch.empty_like(x)
    err = kernel("mad_stencil_halfsweep", x.dtype)(
        op.planes.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(),
        *op.shape, int(color), stream_of(x),
    )
    check_launch(err, "halfsweep")
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
    out = torch.empty_like(x)
    err = kernel("mad_stencil_residual", x.dtype)(
        op.planes.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(),
        *op.shape, stream_of(x),
    )
    check_launch(err, "cuda_residual")
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
    out = torch.empty_like(x)
    err = kernel("mad_stencil_halfsweep_local", x.dtype)(
        op.planes.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(),
        *op.shape, int(color), stream_of(x),
    )
    check_launch(err, "halfsweep_local")
    halfsweep_local.launches += 1
    return out


halfsweep_local.launches = 0


def cuda_residual_local(op: CompressedDCAOperator, x: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The residual on a block, with every term across its border dropped."""
    if x.device.type == "cpu":
        return residual_local_plain(op, x, b)
    _check("cuda_residual_local", op, x, b)
    out = torch.empty_like(x)
    err = kernel("mad_stencil_residual_local", x.dtype)(
        op.planes.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(),
        *op.shape, stream_of(x),
    )
    check_launch(err, "cuda_residual_local")
    cuda_residual_local.launches += 1
    return out


cuda_residual_local.launches = 0
