"""Compressed DCA operator: the 19/9-point stencil stored as 10/6 planes.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.compressed``.  The DCA
discretization's twelve edge (mixed) coefficients in 3D are ``±m_dd2`` of
just three planes, Neumann folding keeps that structure (the folded mixed
coefficient is ``m`` masked to zero on the border shells of both of its
dimensions), and folding never touches the diagonal.  So ``A`` is exactly
``2D face + D(D-1)/2 mixed + 1 diag`` planes: 10 in 3D, 6 in 2D.

The planes are one ``(P, *shape)`` tensor in the order the stencil kernel
takes them: for each dimension its ``+e_d`` and ``-e_d`` face planes, then
the mixed planes by pair ``(d, d2)``, ``d < d2``, then the diagonal.  In 3D
with axes (z, y, x) that is
``fp_z, fm_z, fp_y, fm_y, fp_x, fm_x, m_zy, m_zx, m_yx, diag``.

:func:`assemble_compressed_dca` is the plain PyTorch version of the
assembly kernel (:mod:`.cuda_assemble`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.stencil import pad, shifted
from ..core.symfield import sym_component
from .dca import _tensor_derivative


def n_planes(ndim: int) -> int:
    return 2 * ndim + ndim * (ndim - 1) // 2 + 1


def _mixed_pairs(ndim: int) -> Tuple[Tuple[int, int], ...]:
    return tuple((d, d2) for d in range(ndim) for d2 in range(d + 1, ndim))


class CompressedDCAOperator:
    """Folded DCA operator in compressed plane form (``planes``: ``(P,
    *shape)``, layout in the module docstring)."""

    def __init__(self, planes: torch.Tensor, ndim: int):
        if planes.shape[0] != n_planes(ndim) or planes.dim() != ndim + 1:
            raise ValueError(
                f"expected ({n_planes(ndim)}, *shape) planes for {ndim}D, "
                f"got {tuple(planes.shape)}"
            )
        self.planes = planes
        self._ndim = ndim

    @property
    def ndim(self) -> int:
        return self._ndim

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.planes.shape[1:])

    @property
    def diag(self) -> torch.Tensor:
        return self.planes[-1]

    def astype(self, dtype: torch.dtype) -> "CompressedDCAOperator":
        return CompressedDCAOperator(self.planes.to(dtype), self._ndim)

    def offdiag_apply(self, x: torch.Tensor) -> torch.Tensor:
        ndim = self._ndim
        shape = self.shape
        xp = pad(x, 1)

        def e(d, s=1):
            off = [0] * ndim
            off[d] = s
            return tuple(off)

        def sh(off):
            return shifted(xp, off, 1, shape)

        out = None
        for d in range(ndim):
            term = self.planes[2 * d] * sh(e(d, 1)) + self.planes[2 * d + 1] * sh(e(d, -1))
            out = term if out is None else out + term
        for k, (d, d2) in enumerate(_mixed_pairs(ndim)):
            pp = tuple(a + b for a, b in zip(e(d, 1), e(d2, 1)))
            pm = tuple(a + b for a, b in zip(e(d, 1), e(d2, -1)))
            mp = tuple(a + b for a, b in zip(e(d, -1), e(d2, 1)))
            mm = tuple(a + b for a, b in zip(e(d, -1), e(d2, -1)))
            out = out + self.planes[2 * ndim + k] * (sh(pp) - sh(pm) - sh(mp) + sh(mm))
        return out

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.diag * x + self.offdiag_apply(x)

    def __repr__(self) -> str:
        return f"CompressedDCAOperator(shape={self.shape})"


def _border_mask(shape, d: int, dtype, device) -> torch.Tensor:
    """1 in the interior of dimension d, 0 on its first/last shell."""
    ids = torch.arange(shape[d], device=device)
    m = ((ids > 0) & (ids < shape[d] - 1)).to(dtype)
    view = [1] * len(shape)
    view[d] = shape[d]
    return m.reshape(view)


def assemble_compressed_dca(tensor: torch.Tensor, spacing: Tuple[float, ...],
                            time_step: float) -> CompressedDCAOperator:
    """Assemble the compressed folded DCA operator from the ``(S, *shape)``
    tensor stack (the plain version of the assembly kernel)."""
    ndim = len(spacing)
    shape = tuple(tensor.shape[1:])
    dt = float(time_step)
    kw = dict(dtype=tensor.dtype, device=tensor.device)

    faces = []
    diag = torch.ones(shape, **kw)
    for d in range(ndim):
        v2 = (-dt / (spacing[d] * spacing[d])) * sym_component(tensor, ndim, d, d)
        diag = diag - 2.0 * v2
        t = None
        for d2 in range(ndim):
            w = -dt / (4.0 * spacing[d] * spacing[d2])
            dm = _tensor_derivative(sym_component(tensor, ndim, d, d2), d2) * w
            t = dm if t is None else t + dm
        cp = v2 + t
        cm = v2 - t
        # Neumann folding along d: the first shell's -e_d coefficient folds
        # onto +e_d, the last shell's +e_d onto -e_d
        # (itkGridsHierarchy.hxx:362-363).
        first = [slice(None)] * ndim
        first[d] = slice(0, 1)
        first = tuple(first)
        last = [slice(None)] * ndim
        last[d] = slice(shape[d] - 1, shape[d])
        last = tuple(last)
        cp[first] += cm[first]
        cm[first] = 0.0
        cm[last] += cp[last]
        cp[last] = 0.0
        faces += [cp, cm]

    mixed = []
    for d, d2 in _mixed_pairs(ndim):
        m = 2.0 * (-dt / (4.0 * spacing[d] * spacing[d2])) * sym_component(
            tensor, ndim, d, d2
        )
        # folding cancels the mixed couplings exactly on the border shells
        # of both participating dimensions
        mixed.append(m * _border_mask(shape, d, **kw) * _border_mask(shape, d2, **kw))

    return CompressedDCAOperator(torch.stack(faces + mixed + [diag]), ndim)
