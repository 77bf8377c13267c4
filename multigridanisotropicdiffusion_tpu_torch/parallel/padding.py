"""Pad-to-divisible distribution: split odd-sized volumes fully.

Counterpart of ``multigridanisotropicdiffusion_tpu.parallel.padding``.  The
block layout (:mod:`.sharding`) splits a dimension only where it divides
evenly over its mesh axis, so :func:`.sharding.level_spec` would replicate
any other dimension and lose the parallelism exactly on real shapes (69 x
77 x 69, 513^3).  Instead each level is embedded into a mesh-divisible
padded domain:

* operator planes are zero-padded and the diagonal is padded with ones:
  pad cells solve the decoupled identity equation ``1 * x = 0``;
* fields (right-hand sides, iterates) are zero-padded;
* the boundary-folded operator has exactly-zero coefficients pointing out of
  the true domain, so no true cell reads a pad cell, and pad cells (zero
  right-hand side, identity row) stay exactly zero through every sweep and
  residual;
* the transfers between levels act on the true rows only (their pad rows
  are zero, :mod:`.transfer`), and the coarsest direct solve crops to the
  true shape and re-pads, so the padded solve is the unpadded one on the
  true cells, with the same global L2 norms.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.stencil import StencilOperator
from ..ops.compressed import CompressedDCAOperator
from .sharding import DEFAULT_MIN_LOCAL, GridMesh


def padded_level_shape(mesh: GridMesh, shape: Tuple[int, ...],
                       min_local: int = DEFAULT_MIN_LOCAL) -> Tuple[int, ...]:
    """The mesh-divisible embedding of a level of ``shape``: dimension d is
    padded up to ``ceil(s / per) * per`` when splitting it is worthwhile
    (mesh axis > 1 and blocks of at least ``min_local`` points); otherwise it
    keeps its size (and is replicated)."""
    out = []
    for d, s in enumerate(shape):
        if d < mesh.ndim:
            per = mesh.shape[d]
            if per > 1 and s // per >= min_local:
                out.append(-(-s // per) * per)
                continue
        out.append(s)
    return tuple(out)


def pad_field(x: torch.Tensor, pshape: Tuple[int, ...], value: float = 0.0) -> torch.Tensor:
    """Embed ``x`` at the origin of a ``pshape`` array filled with ``value``
    (the trailing ``len(pshape)`` dimensions)."""
    shape = tuple(x.shape[x.dim() - len(pshape):])
    if shape == tuple(pshape):
        return x
    pads = []
    for s, p in reversed(list(zip(shape, pshape))):
        pads += [0, p - s]
    return F.pad(x, pads, value=value)


def crop_field(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`pad_field`: the leading ``shape`` block."""
    lead = x.dim() - len(shape)
    if tuple(x.shape[lead:]) == tuple(shape):
        return x
    return x[(slice(None),) * lead + tuple(slice(0, s) for s in shape)]


def pad_operator(op, pshape: Tuple[int, ...]):
    """Embed an operator into the padded domain: off-diagonal planes padded
    with zeros, the diagonal with ones (pad rows are identity equations)."""
    if tuple(op.shape) == tuple(pshape):
        return op
    if isinstance(op, CompressedDCAOperator):
        planes = pad_field(op.planes, pshape)
        planes[-1] = pad_field(op.planes[-1], pshape, 1.0)
        return CompressedDCAOperator(planes, op.ndim)
    if isinstance(op, StencilOperator):
        coeffs = pad_field(op.coeffs, pshape)
        c = op.center_index
        coeffs[c] = pad_field(op.coeffs[c], pshape, 1.0)
        return StencilOperator(coeffs, op.offsets)
    raise TypeError(f"pad_operator takes stored or compressed operators, got {type(op)}")


def pad_hierarchy(hierarchy, pshapes: Tuple[Tuple[int, ...], ...]):
    """Pad every level's operator (the coarsest direct solver stays on the
    true shape: the padded solve crops before it)."""
    from ..models.mad import Hierarchy

    ops = tuple(pad_operator(op, ps) for op, ps in zip(hierarchy.operators, pshapes))
    return Hierarchy(operators=ops, solver=hierarchy.solver)
