"""Smoothers for the multigrid cycle: weighted Jacobi and red-black Gauss-Seidel.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.smoothers``.  The
reference's lexicographic Gauss-Seidel is sequential, so Gauss-Seidel here is
red-black: two half-sweeps, each updating one parity class from the *old*
field.  A half-sweep is out of place on purpose: the 19/9-point DCA stencil's
mixed offsets couple cells of the same colour, so an in-place update would
read values already overwritten in the same half-sweep.  Red (even index
sum) goes first.

``make_smoother``/``make_residual`` with ``use_kernels`` send the 3D
compressed operator to the stencil kernel's wrappers
(:mod:`.cuda_smoothers`); for a CPU tensor those take the plain version.
The Chebyshev smoother is not ported yet (ROADMAP A10).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..core.stencil import compute_dtype, residual
from .compressed import CompressedDCAOperator

#: Default damping for weighted Jacobi (itkMultigridWeightedJacobiSmoother.hxx:189).
DEFAULT_JACOBI_WEIGHT = 2.0 / 3.0

_GS = ("gauss_seidel", "gs", "rbgs")
_JACOBI = ("weighted_jacobi", "wj", "jacobi")
_CHEBYSHEV = ("chebyshev", "cheby")


def parity_mask(shape: Tuple[int, ...], device=None) -> torch.Tensor:
    """Checkerboard mask: True where the index sum is even ("red" points)."""
    acc = torch.zeros((), dtype=torch.int64, device=device)
    for d, s in enumerate(shape):
        view = [1] * len(shape)
        view[d] = s
        acc = acc + torch.arange(s, device=device).reshape(view)
    return acc % 2 == 0


def jacobi_sweep(op, x: torch.Tensor, b: torch.Tensor,
                 omega: float = DEFAULT_JACOBI_WEIGHT) -> torch.Tensor:
    """One damped-Jacobi sweep:
    ``x' = (1-w) x + w (b - offdiag(A) x) / diag(A)``."""
    cd = compute_dtype(x.dtype)
    xc = x.to(cd)
    out = (1.0 - omega) * xc + omega * (b.to(cd) - op.offdiag_apply(xc)) / op.diag.to(cd)
    return out.to(x.dtype)


def gs_halfsweep(op, x: torch.Tensor, b: torch.Tensor, color: int) -> torch.Tensor:
    """One Gauss-Seidel half-sweep, out of place: every cell's update is
    computed from the old ``x``, and cells whose index-sum parity equals
    ``color`` (0 = red) take it."""
    cd = compute_dtype(x.dtype)
    xc = x.to(cd)
    upd = (b.to(cd) - op.offdiag_apply(xc)) / op.diag.to(cd)
    red = parity_mask(tuple(x.shape), x.device)
    return torch.where(red == (color == 0), upd, xc).to(x.dtype)


def rb_gauss_seidel_sweep(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep (red half-sweep, then black)."""
    for color in (0, 1):
        x = gs_halfsweep(op, x, b, color)
    return x


def has_kernel(op) -> bool:
    """Whether ``op`` has a stencil kernel: the 3D compressed operator."""
    return isinstance(op, CompressedDCAOperator) and op.ndim == 3


def refuse_without_kernel(op, x: torch.Tensor) -> None:
    """With ``use_kernels`` a CUDA tensor must reach a kernel: raise for the
    operators whose kernels are not ported yet."""
    if not x.is_cuda:
        return
    if isinstance(op, CompressedDCAOperator):
        raise NotImplementedError(
            "the 2D compressed-operator stencil kernel is not ported yet "
            "(ROADMAP B13); use use_kernels=False"
        )
    raise NotImplementedError(
        f"{op!r} has no CUDA stencil kernel yet (stored operators: ROADMAP "
        "B12/B13); use operator_repr='compressed' or use_kernels=False"
    )


def make_smoother(kind: str, omega: float = DEFAULT_JACOBI_WEIGHT,
                  use_kernels: bool = False):
    """Return ``smooth(op, x, b) -> x'`` for the named smoother.

    ``kind``: 'gauss_seidel' (red-black) or 'weighted_jacobi'.
    ``use_kernels``: 3D compressed-operator GS sweeps go through the stencil
    kernel; on a CUDA tensor any other operator raises.
    """
    if kind in _GS:
        if not use_kernels:
            return rb_gauss_seidel_sweep

        def sweep(op, x, b):
            if has_kernel(op):
                from .cuda_smoothers import rbgs_sweep

                return rbgs_sweep(op, x, b)
            refuse_without_kernel(op, x)
            return rb_gauss_seidel_sweep(op, x, b)

        return sweep
    if kind in _JACOBI:
        return functools.partial(jacobi_sweep, omega=omega)
    if kind in _CHEBYSHEV:
        raise NotImplementedError("the Chebyshev smoother is not ported yet (ROADMAP A10)")
    raise ValueError(f"unknown smoother kind: {kind!r}")


def make_residual(use_kernels: bool = False):
    """Return ``resid(op, x, b) -> b - A x``; with ``use_kernels`` the 3D
    compressed operator goes through the stencil kernel's residual."""
    if not use_kernels:
        return residual

    def resid(op, x, b):
        if has_kernel(op):
            from .cuda_smoothers import cuda_residual

            return cuda_residual(op, x, b)
        refuse_without_kernel(op, x)
        return residual(op, x, b)

    return resid
