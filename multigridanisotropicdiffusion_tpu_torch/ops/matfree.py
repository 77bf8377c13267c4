"""Matrix-free DCA operator: ``A = Id - dt*L`` applied directly from the
``(S, *shape)`` diffusion-tensor stack, with no stored coefficient planes.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.matfree``.  The
reference folds its Neumann boundary conditions into the interior
coefficients by reflecting out-of-range offsets (itkGridsHierarchy.hxx:
349-430); applying the unfolded coefficients to a mirror-padded field
(``x[-1] = x[1]``) gives the same sum, so this operator equals the stored
one of :func:`..ops.dca.assemble_dca` up to the order of the sums.  The
transport coefficients use the assembly's tensor derivative
(:func:`..ops.dca._tensor_derivative`), and the centre coefficient, which
no reflection reaches, is ``1 + sum_d 2 dt/h_d^2 M_dd``.

It has no kernel, in the JAX package (plain XLA there) or here:
``ops.smoothers.has_kernel`` is False for it, so its sweeps and residuals
run as plain PyTorch on every device.  Low-precision tensor planes are read
in the compute dtype (float32 for bf16), the rule of every operator of the
port.  ``apply`` and ``offdiag_apply`` take any leading batch axes before
the grid axes (the Galerkin probes apply a batch at once).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.stencil import compute_dtype, stencil_offsets
from ..core.symfield import sym_component
from .dca import _tensor_derivative


def _mirror_pad(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` with one mirrored ghost layer on each side of its last ``ndim``
    axes (``ghost(-1) = x[1]``, ``ghost(n) = x[n - 2]``)."""
    for axis in range(x.dim() - ndim, x.dim()):
        n = x.shape[axis]
        idx = torch.arange(-1, n + 1, device=x.device)
        x = x.index_select(axis, (n - 1) - ((n - 1) - idx.abs()).abs())
    return x


def _mirror_shift(xp: torch.Tensor, offset, shape) -> torch.Tensor:
    """View of the mirror-padded field whose element ``p`` is ``x[p +
    offset]``, over the trailing grid axes."""
    return xp[(..., *(slice(1 + o, 1 + o + s) for o, s in zip(offset, shape)))]


class MatrixFreeDCAOperator:
    """DCA operator applied on the fly from the tensor stack, with the
    protocol of the port's other operators (``apply``, ``offdiag_apply``,
    ``diag``, ``offdiag_abs_rowsum``, ``offsets``, ``shape``, ``ndim``,
    ``dtype``, ``astype``)."""

    def __init__(self, tensor: torch.Tensor, spacing: Tuple[float, ...],
                 time_step: float):
        self.tensor = tensor
        self.spacing = tuple(float(h) for h in spacing)
        self.time_step = float(time_step)
        if tensor.dim() != self.ndim + 1 or tensor.shape[0] != self.ndim * (self.ndim + 1) // 2:
            raise ValueError(f"expected a ({self.ndim * (self.ndim + 1) // 2}, *shape) "
                             f"tensor stack for {self.ndim}D, got {tuple(tensor.shape)}")

    @property
    def ndim(self) -> int:
        return len(self.spacing)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.tensor.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    @property
    def offsets(self):
        """The structural offset table (the 19/9-point DCA pattern), so that
        Galerkin probing can treat this operator like a stored one."""
        return stencil_offsets(self.ndim)

    def astype(self, dtype: torch.dtype) -> "MatrixFreeDCAOperator":
        return MatrixFreeDCAOperator(self.tensor.to(dtype), self.spacing, self.time_step)

    def _m(self, d: int, d2: int) -> torch.Tensor:
        return sym_component(self.tensor, self.ndim, d, d2).to(compute_dtype(self.dtype))

    @property
    def diag(self) -> torch.Tensor:
        dt = self.time_step
        out = None
        for d in range(self.ndim):
            term = (2.0 * dt / self.spacing[d] ** 2) * self._m(d, d)
            out = term if out is None else out + term
        return 1.0 + out

    def _face_weights(self, d: int):
        """``(v2, t)``: the second-derivative weight ``v2`` on ``±e_d`` and
        the transport term ``t`` (``v2 + t`` on ``+e_d``, ``v2 - t`` on
        ``-e_d``)."""
        dt, h = self.time_step, self.spacing
        v2 = (-dt / (h[d] * h[d])) * self._m(d, d)
        t = None
        for d2 in range(self.ndim):
            w = -dt / (4.0 * h[d] * h[d2])
            dm = _tensor_derivative(self._m(d, d2), d2) * w
            t = dm if t is None else t + dm
        return v2, t

    def _mixed_weight(self, d: int, d2: int) -> torch.Tensor:
        # the (d, d2) and (d2, d) passes of the assembly each add M*w
        dt, h = self.time_step, self.spacing
        return 2.0 * (-dt / (4.0 * h[d] * h[d2])) * self._m(d, d2)

    def _offdiag_terms(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every off-centre stencil term on the mirror-padded ``x``."""
        ndim, shape = self.ndim, self.shape
        xp = _mirror_pad(x, ndim)

        def e(d, s=1):
            off = [0] * ndim
            off[d] = s
            return tuple(off)

        def add(a, b):
            return tuple(p + q for p, q in zip(a, b))

        out = None
        for d in range(ndim):
            v2, t = self._face_weights(d)
            for term in ((v2 + t) * _mirror_shift(xp, e(d, 1), shape),
                         (v2 - t) * _mirror_shift(xp, e(d, -1), shape)):
                out = term if out is None else out + term
        for d in range(ndim):
            for d2 in range(d + 1, ndim):
                m = self._mixed_weight(d, d2)
                out = out + m * (
                    _mirror_shift(xp, add(e(d, 1), e(d2, 1)), shape)
                    - _mirror_shift(xp, add(e(d, 1), e(d2, -1)), shape)
                    - _mirror_shift(xp, add(e(d, -1), e(d2, 1)), shape)
                    + _mirror_shift(xp, add(e(d, -1), e(d2, -1)), shape)
                )
        return out

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.diag * x + self._offdiag_terms(x)

    def offdiag_apply(self, x: torch.Tensor) -> torch.Tensor:
        return self._offdiag_terms(x)

    def offdiag_abs_rowsum(self) -> torch.Tensor:
        """Per-row sum of |off-diagonal coefficients| (Gershgorin radius)."""
        out = None
        for d in range(self.ndim):
            v2, t = self._face_weights(d)
            term = torch.abs(v2 + t) + torch.abs(v2 - t)
            out = term if out is None else out + term
        for d in range(self.ndim):
            for d2 in range(d + 1, self.ndim):
                out = out + 4.0 * torch.abs(self._mixed_weight(d, d2))
        return out

    def __repr__(self) -> str:
        return f"MatrixFreeDCAOperator(shape={self.shape}, dt={self.time_step})"
