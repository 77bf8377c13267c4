"""The 2D stencil kernel: red-black Gauss-Seidel half-sweeps and the
residual on the 2D compressed DCA operator and on 2D stored radius-1
operators (``csrc/stencil_2d.cu``).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_smoothers``
in its 2D form (``_build_stencil_pass_2d``): the compressed operator's six
``(fp_y, fm_y, fp_x, fm_x, m_yx, diag)`` planes, or a stored operator's at
most nine planes with its tap plan (``cuda_stencil_stored.tap_plan``) and
centre index as launch arguments: the stored form is B12's kernel on one
plane, every product and sum rounded on its own, so it is its plain
version's bytes.  Each wrapper takes the plain PyTorch version for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.  Storage may be float32,
bfloat16 or float64; 16-bit storage computes in float32 and rounds once at
the store.

``halfsweep.launches`` and ``cuda_residual.launches`` count kernel launches
of both forms.
"""

from __future__ import annotations

import torch

from ..core.stencil import StencilOperator
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .compressed import CompressedDCAOperator
from .cuda_stencil_stored import (
    check_grid,
    halfsweep_plain,
    layout,
    rbgs_sweep_plain,
    residual_plain,
    tap_plan,
)

__all__ = ["cuda_residual", "halfsweep", "halfsweep_plain", "rbgs_sweep",
           "rbgs_sweep_plain", "residual_plain"]


def _check(name: str, op, x: torch.Tensor, b: torch.Tensor) -> None:
    if isinstance(op, CompressedDCAOperator):
        if op.ndim != 2:
            raise ValueError(f"{name}: needs a 2D operator, got {op!r}")
        planes = op.planes
    elif isinstance(op, StencilOperator) and layout(op.offsets)[:2] == (2, 1):
        planes = op.coeffs
    else:
        raise ValueError(f"{name}: needs a 2D compressed operator or a 2D stored "
                         f"operator of radius 1, got {op!r}")
    require_cuda(name, planes, x, b)
    if tuple(x.shape) != op.shape or tuple(b.shape) != op.shape:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} / b {tuple(b.shape)} != operator {op.shape}"
        )
    if isinstance(op, CompressedDCAOperator):
        if (op.shape[0] + 7) // 8 > 65535:
            raise ValueError(f"{name}: grid of {op.shape} exceeds the launch limits")
    else:
        check_grid(name, op.shape, x.dtype)


def _launch(kind: str, op, x, b, *color) -> torch.Tensor:
    out = torch.empty_like(x)
    args = (x.data_ptr(), b.data_ptr(), out.data_ptr(), *op.shape)
    if isinstance(op, CompressedDCAOperator):
        entry = f"mad_stencil2d_compressed_{kind}"
        err = kernel(entry, x.dtype)(op.planes.data_ptr(), *args, *color,
                                     stream_of(x))
    else:
        entry = f"mad_stencil2d_stored_{kind}"
        plan = tap_plan(op.offsets)
        err = kernel(entry, x.dtype)(op.coeffs.data_ptr(), *args, plan.ctypes.data,
                                     len(plan), layout(op.offsets)[2], *color,
                                     stream_of(x))
    check_launch(err, entry)
    return out


def halfsweep(op, x: torch.Tensor, b: torch.Tensor, color: int) -> torch.Tensor:
    """One half-sweep updating the cells of parity ``color`` (0 = red, even
    ``y + x``), out of place."""
    if x.device.type == "cpu":
        return halfsweep_plain(op, x, b, color)
    _check("halfsweep", op, x, b)
    out = _launch("halfsweep", op, x, b, int(color))
    halfsweep.launches += 1
    return out


halfsweep.launches = 0


def rbgs_sweep(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep: red half-sweep, then black."""
    for color in (0, 1):
        x = halfsweep(op, x, b, color)
    return x


def cuda_residual(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Residual ``r = b - A x``."""
    if x.device.type == "cpu":
        return residual_plain(op, x, b)
    _check("cuda_residual", op, x, b)
    out = _launch("residual", op, x, b)
    cuda_residual.launches += 1
    return out


cuda_residual.launches = 0
