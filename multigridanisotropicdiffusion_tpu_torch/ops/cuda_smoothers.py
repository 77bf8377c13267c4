"""The stencil kernel on the 3D compressed DCA operator: red-black
Gauss-Seidel half-sweeps and the residual (``csrc/stencil_compressed.cu``).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_smoothers``
(its compressed 3D form: ``pallas_rbgs_halfsweep``, ``pallas_rbgs_sweep``,
``pallas_residual``).  Each wrapper takes the plain PyTorch version for a
CPU tensor; for a CUDA tensor it launches the kernel or raises.  Storage may
be float32, bfloat16 or float64; 16-bit storage computes in float32 and
rounds once at the store, in the kernel and in the plain versions alike.

``halfsweep.launches`` and ``cuda_residual.launches`` count kernel launches.
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
