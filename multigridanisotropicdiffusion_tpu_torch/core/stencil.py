"""Stencil-operator container and application.

Counterpart of ``multigridanisotropicdiffusion_tpu.core.stencil``.  An
operator is a ``(K, *grid_shape)`` tensor of coefficient planes, one per
active offset, plus a static offset table:
``(A x)[p] = sum_k coeffs[k][p] * x[p + offsets[k]]`` with out-of-range reads
treated as zero.  The operator assembly (:mod:`..ops.dca`) folds the Neumann
boundary conditions into in-range coefficients, so zero padding is the
correct boundary treatment here.

Low-precision storage (bf16/f16) computes in float32 and rounds once at the
end (:func:`compute_dtype`), the rule the CUDA kernels follow too.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

Offset = Tuple[int, ...]


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Arithmetic precision for a storage dtype: float32 for 16-bit floats,
    the dtype itself otherwise."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def stencil_offsets(ndim: int, radius: int = 1, drop_corners: bool | None = None) -> Tuple[Offset, ...]:
    """Canonical ordered offset table for a dense radius-``radius`` stencil.

    In 3D the reference deactivates the 8 corner offsets, leaving a 19-point
    stencil (itkGridsHierarchy.hxx:492-513); ``drop_corners=None`` applies
    that rule automatically for ``ndim == 3`` with radius 1.
    """
    if drop_corners is None:
        drop_corners = ndim == 3 and radius == 1
    offsets = []
    for off in itertools.product(range(-radius, radius + 1), repeat=ndim):
        if drop_corners and all(o != 0 for o in off):
            continue
        offsets.append(tuple(off))
    return tuple(offsets)


class StencilOperator:
    """A linear operator ``A`` stored as per-offset coefficient planes
    (``coeffs``: ``(K, *shape)`` tensor, ``offsets``: K static offsets)."""

    def __init__(self, coeffs: torch.Tensor, offsets: Tuple[Offset, ...]):
        self.coeffs = coeffs
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        if coeffs.shape[0] != len(self.offsets):
            raise ValueError(
                f"{coeffs.shape[0]} coefficient planes != {len(self.offsets)} offsets"
            )

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.coeffs.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def radius(self) -> int:
        return max(abs(o) for off in self.offsets for o in off)

    @property
    def center_index(self) -> int:
        return self.offsets.index((0,) * self.ndim)

    @property
    def diag(self) -> torch.Tensor:
        """Coefficient plane of the center offset (the matrix diagonal)."""
        return self.coeffs[self.center_index]

    def offset_index(self, off: Offset) -> int:
        """Index of the coefficient plane of offset ``off``."""
        return self.offsets.index(tuple(off))

    def astype(self, dtype: torch.dtype) -> "StencilOperator":
        return StencilOperator(self.coeffs.to(dtype), self.offsets)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return apply_stencil(self, x)

    def offdiag_apply(self, x: torch.Tensor) -> torch.Tensor:
        return offdiag_apply(self, x)

    def offdiag_abs_rowsum(self) -> torch.Tensor:
        """Per-row sum of |off-diagonal coefficients| (Gershgorin radius)."""
        c = self.center_index
        out = None
        for k, plane in enumerate(self.coeffs):
            if k != c:
                out = plane.abs() if out is None else out + plane.abs()
        return out

    def __repr__(self) -> str:
        return f"StencilOperator(K={len(self.offsets)}, shape={self.shape})"


def pad(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Zero-pad every axis of ``x`` by ``radius`` on both sides."""
    return F.pad(x, (radius, radius) * x.dim())


def shifted(xp: torch.Tensor, offset: Offset, radius: int,
            shape: Tuple[int, ...]) -> torch.Tensor:
    """View of the padded field ``xp`` whose element ``p`` is ``x[p + offset]``."""
    return xp[tuple(slice(radius + o, radius + o + s) for o, s in zip(offset, shape))]


def _contract(op: StencilOperator, x: torch.Tensor, skip_center: bool) -> torch.Tensor:
    r = op.radius
    xp = pad(x, r)
    c = op.center_index
    out = None
    for k, off in enumerate(op.offsets):
        if skip_center and k == c:
            continue
        term = op.coeffs[k] * shifted(xp, off, r, x.shape)
        out = term if out is None else out + term
    return out


def apply_stencil(op: StencilOperator, x: torch.Tensor) -> torch.Tensor:
    """``A x`` — the K-term stencil contraction."""
    return _contract(op, x, skip_center=False)


def offdiag_apply(op: StencilOperator, x: torch.Tensor) -> torch.Tensor:
    """``(A - diag(A)) x`` — used by both smoothers."""
    return _contract(op, x, skip_center=True)


def residual(op, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``r = b - A x`` for any operator with ``apply``, in the compute dtype
    of ``x``'s storage, rounded once to it."""
    cd = compute_dtype(x.dtype)
    return (b.to(cd) - op.apply(x.to(cd))).to(x.dtype)


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """Plain (unnormalized) L2 norm, the reference's ``L2Norm``."""
    return torch.sqrt(torch.sum(x * x))


def densify(op: StencilOperator) -> torch.Tensor:
    """Expand the operator into a dense ``(N, N)`` matrix (C-order rows and
    columns); entries whose column falls outside the grid are dropped.  Only
    for the tiny coarsest level."""
    shape = op.shape
    n = int(np.prod(shape))
    a = torch.zeros((n, n), dtype=op.dtype, device=op.coeffs.device)
    lex = np.arange(n).reshape(shape)
    for k, off in enumerate(op.offsets):
        row_sl = tuple(slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape))
        col_sl = tuple(slice(max(0, o), s - max(0, -o)) for o, s in zip(off, shape))
        rows = torch.as_tensor(lex[row_sl].ravel(), device=a.device)
        cols = torch.as_tensor(lex[col_sl].ravel(), device=a.device)
        a[rows, cols] = op.coeffs[k][row_sl].reshape(-1)
    return a
