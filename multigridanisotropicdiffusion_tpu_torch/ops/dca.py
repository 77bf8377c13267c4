"""DCA (discretization coarse-grid approximation) operator assembly, stored form.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.dca``: builds the
implicit-Euler matrix ``A = Id - dt * L`` where ``L`` discretizes
``div(M grad u)`` with homogeneous Neumann boundary conditions, for a
per-voxel symmetric diffusion tensor ``M`` (reference
``mad::GridsHierarchy::GenerateDCA``, itkGridsHierarchy.hxx:298-516):

* center coefficient initialized to 1 (the identity term),
* per dimension ``d``: ``-dt/h_d^2 * M_dd`` on ``±e_d`` and ``+2 dt/h_d^2 *
  M_dd`` on the center,
* per ordered pair ``(d, d2)``, ``d != d2``: mixed term ``-dt/(4 h_d h_d2) *
  M_dd2`` on the four diagonal offsets (each unordered pair twice),
* per ordered pair ``(d, d2)`` including ``d2 == d``: the transport term
  ``(∂_d2 M_dd2) ∂_d u`` from a central difference of the tensor (one-sided
  at the borders) on ``±e_d``,
* Neumann BCs by offset reflection at every border.

The port keeps this stored form for the coarsest level's dense LU; the
solve's levels use the compressed form (:mod:`.compressed`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.stencil import Offset, StencilOperator, stencil_offsets
from ..core.symfield import sym_component


def _axis_slice(x: torch.Tensor, axis: int, start, stop) -> torch.Tensor:
    sl = [slice(None)] * x.dim()
    sl[axis] = slice(start, stop)
    return x[tuple(sl)]


def _tensor_derivative(m: torch.Tensor, axis: int) -> torch.Tensor:
    """Derivative surrogate of a tensor plane along ``axis``: interior
    ``M[i+1] - M[i-1]`` (2h times the central difference), borders
    ``-3 M[0] + 4 M[1] - M[2]`` / ``3 M[-1] - 4 M[-2] + M[-3]``
    (itkGridsHierarchy.hxx:451-470).  The 1/(2h) factor is the caller's."""
    n = m.shape[axis]
    left = (
        -3.0 * _axis_slice(m, axis, 0, 1)
        + 4.0 * _axis_slice(m, axis, 1, 2)
        - 1.0 * _axis_slice(m, axis, 2, 3)
    )
    interior = _axis_slice(m, axis, 2, n) - _axis_slice(m, axis, 0, n - 2)
    right = (
        3.0 * _axis_slice(m, axis, n - 1, n)
        - 4.0 * _axis_slice(m, axis, n - 2, n - 1)
        + 1.0 * _axis_slice(m, axis, n - 3, n - 2)
    )
    return torch.cat([left, interior, right], dim=axis)


def _flip_component(off: Offset, d: int) -> Offset:
    out = list(off)
    out[d] = -out[d]
    return tuple(out)


def _reflect_boundaries(
    contrib: Dict[Offset, torch.Tensor], shape: Tuple[int, ...]
) -> Dict[Offset, torch.Tensor]:
    """Fold out-of-range stencil entries onto their mirror offsets, one
    dimension after the other (itkGridsHierarchy.hxx:388-430): at the first
    slice of ``d`` every offset with a ``-1`` d-component moves onto the
    offset with that component flipped, and symmetrically at the last.
    Updates the planes of ``contrib`` in place."""
    ndim = len(shape)
    for d in range(ndim):
        first = [slice(None)] * ndim
        first[d] = slice(0, 1)
        last = [slice(None)] * ndim
        last[d] = slice(shape[d] - 1, shape[d])
        for sign, sl in ((-1, tuple(first)), (1, tuple(last))):
            moves = [(off, _flip_component(off, d)) for off in contrib if off[d] == sign]
            for src, dst in moves:
                if dst not in contrib:
                    contrib[dst] = torch.zeros_like(contrib[src])
                contrib[dst][sl] += contrib[src][sl]
                contrib[src][sl] = 0.0
    return contrib


def assemble_dca(tensor: torch.Tensor, spacing: Tuple[float, ...],
                 time_step: float) -> StencilOperator:
    """Assemble ``A = Id - dt*L`` as a :class:`StencilOperator`.

    ``tensor``: ``(D(D+1)/2, *grid_shape)`` stack in canonical order
    (:mod:`..core.symfield`); ``spacing``: per dimension; ``time_step``: dt.
    """
    ndim = len(spacing)
    shape = tuple(tensor.shape[1:])
    dt = float(time_step)
    center: Offset = (0,) * ndim

    def e(d: int, s: int = 1) -> Offset:
        off = [0] * ndim
        off[d] = s
        return tuple(off)

    contrib: Dict[Offset, torch.Tensor] = {
        center: torch.ones(shape, dtype=tensor.dtype, device=tensor.device)
    }

    def add(off: Offset, value: torch.Tensor) -> None:
        contrib[off] = contrib[off] + value if off in contrib else value.clone()

    for d in range(ndim):
        h_d = spacing[d]
        w2 = -dt / (h_d * h_d)
        v2 = sym_component(tensor, ndim, d, d) * w2
        add(e(d, +1), v2)
        add(e(d, -1), v2)
        add(center, -2.0 * v2)

        for d2 in range(ndim):
            w = -dt / (4.0 * h_d * spacing[d2])
            if d != d2:
                vm = sym_component(tensor, ndim, d, d2) * w
                pp = tuple(a + b for a, b in zip(e(d, +1), e(d2, +1)))
                pm = tuple(a + b for a, b in zip(e(d, +1), e(d2, -1)))
                mp = tuple(a + b for a, b in zip(e(d, -1), e(d2, +1)))
                mm = tuple(a + b for a, b in zip(e(d, -1), e(d2, -1)))
                add(pp, vm)
                add(pm, -vm)
                add(mp, -vm)
                add(mm, vm)
            dm = _tensor_derivative(sym_component(tensor, ndim, d, d2), d2) * w
            add(e(d, +1), dm)
            add(e(d, -1), -dm)

    contrib = _reflect_boundaries(contrib, shape)

    offsets = stencil_offsets(ndim, radius=1)
    zeros = torch.zeros(shape, dtype=tensor.dtype, device=tensor.device)
    coeffs = torch.stack([contrib.get(off, zeros) for off in offsets])
    return StencilOperator(coeffs, offsets)
