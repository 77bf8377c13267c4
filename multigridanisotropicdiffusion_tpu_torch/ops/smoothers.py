"""Smoothers for the multigrid cycle: weighted Jacobi, red-black Gauss-Seidel
and Chebyshev.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.smoothers``.  The
reference's lexicographic Gauss-Seidel is sequential, so Gauss-Seidel here is
red-black: two half-sweeps, each updating one parity class from the *old*
field.  A half-sweep is out of place on purpose: the 19/9-point DCA stencil's
mixed offsets couple cells of the same colour, so an in-place update would
read values already overwritten in the same half-sweep.  Red (even index
sum) goes first.

``make_smoother``/``make_residual`` with ``use_kernels`` send every
operator that the JAX package sends to its Pallas kernels
(``cuda_smoothers.kernel_takes``, its ``pallas_compatible``) to the stencil
kernels' entry points in :mod:`.cuda_smoothers`, which dispatch on the
operator's form (3D compressed, 3D stored, 2D).  For a CPU tensor those
take their plain versions; for a CUDA tensor they launch the kernel or
raise.  The Chebyshev smoother has no kernel, in the JAX package or here:
it runs as plain PyTorch on every device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..core.stencil import compute_dtype, residual

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


def make_smoother(kind: str, omega: float = DEFAULT_JACOBI_WEIGHT,
                  use_kernels: bool = False):
    """Return ``smooth(op, x, b) -> x'`` for the named smoother.

    ``kind``: 'gauss_seidel' (red-black), 'weighted_jacobi' or 'chebyshev'.
    ``use_kernels``: the GS sweeps of every operator with a stencil kernel
    (``cuda_smoothers.kernel_takes``) go through it.  An operator the JAX
    package never sends to Pallas (the radius-2 levels of a 2D exact
    Galerkin hierarchy) runs the plain sweep on any device, as the JAX
    package runs it through XLA: that is its path, not a fallback.
    """
    if kind in _GS:
        if not use_kernels:
            return rb_gauss_seidel_sweep
        from . import cuda_smoothers as cs  # which imports this module

        def sweep(op, x, b):
            if cs.kernel_takes(op):
                return cs.rbgs_sweep(op, x, b)
            return rb_gauss_seidel_sweep(op, x, b)

        return sweep
    if kind in _JACOBI:
        return functools.partial(jacobi_sweep, omega=omega)
    if kind in _CHEBYSHEV:
        return chebyshev_smoother
    raise ValueError(f"unknown smoother kind: {kind!r}")


def make_residual(use_kernels: bool = False):
    """Return ``resid(op, x, b) -> b - A x``; with ``use_kernels`` every
    operator with a stencil kernel goes through its residual (the others as
    in :func:`make_smoother`)."""
    if not use_kernels:
        return residual
    from . import cuda_smoothers as cs  # which imports this module

    def resid(op, x, b):
        if cs.kernel_takes(op):
            return cs.cuda_residual(op, x, b)
        return residual(op, x, b)

    return resid


#: Chebyshev smoother defaults: polynomial degree per smooth() call, and the
#: targeted upper spectral fraction [lmax/ratio, lmax] of D^-1 A.
CHEBYSHEV_DEGREE = 3
CHEBYSHEV_EIG_RATIO = 8.0


def chebyshev_smoother(op, x: torch.Tensor, b: torch.Tensor,
                       degree: int = CHEBYSHEV_DEGREE,
                       eig_ratio: float = CHEBYSHEV_EIG_RATIO) -> torch.Tensor:
    """Chebyshev polynomial smoother on the Jacobi-preconditioned operator:
    a degree-``degree`` polynomial in ``D^-1 A`` that damps the band
    ``[lmax/eig_ratio, lmax]``, with ``lmax`` bounded per call by Gershgorin
    (``max(1 + rowsum|offdiag|/diag)``, a device scalar: no host sync).  No
    reference counterpart; the JAX package's smoother of the same name, in
    the compute dtype."""
    cd = compute_dtype(x.dtype)
    xc, bc = x.to(cd), b.to(cd)
    diag = op.diag.to(cd)
    lmax = torch.max(1.0 + op.offdiag_abs_rowsum().to(cd) / diag)
    lmin = lmax / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    r = bc - op.apply(xc)
    d = (r / diag) / theta
    rho = 1.0 / sigma
    for _ in range(degree):
        xc = xc + d
        r = r - op.apply(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (r / diag)
        rho = rho_new
    return (xc + d).to(x.dtype)
