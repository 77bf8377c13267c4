"""Symmetric tensor fields as one contiguous ``(D(D+1)/2, *shape)`` tensor.

Counterpart of ``multigridanisotropicdiffusion_tpu.core.symfield``.  The JAX
package keeps one plane per component in a tuple, a workaround for the TPU's
(8, 128) layout tiling; on a GPU a single contiguous stack is fine and gives
a kernel one base pointer.

Canonical component order: row-major upper triangle —
2D: ``((0,0), (0,1), (1,1))``;
3D: ``((0,0), (0,1), (0,2), (1,1), (1,2), (2,2))``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def sym_pairs(ndim: int) -> Tuple[Tuple[int, int], ...]:
    """Component index pairs in canonical order."""
    return tuple((i, j) for i in range(ndim) for j in range(i, ndim))


def sym_size(ndim: int) -> int:
    return ndim * (ndim + 1) // 2


def sym_index(ndim: int, d: int, d2: int) -> int:
    """Flat index of component (d, d2) (order-insensitive)."""
    i, j = min(d, d2), max(d, d2)
    return sym_pairs(ndim).index((i, j))


def sym_component(planes: torch.Tensor, ndim: int, d: int, d2: int) -> torch.Tensor:
    return planes[sym_index(ndim, d, d2)]


def sym_from_matrix(tensor) -> torch.Tensor:
    """``(D, D, *shape)`` or ``(*shape, D, D)`` matrix field -> the canonical
    ``(S, *shape)`` stack.

    The leading-component layout is tried first, as in the JAX package.  Only
    the lower triangle is read (as the reference filter's SetDiffusionTensor
    does, itkMultigridAnisotropicDiffusionImageFilter.hxx:86-94).  Numpy
    arrays and torch tensors are both accepted.
    """
    t = _as_tensor(tensor)
    shape = tuple(t.shape)
    for ndim in (3, 2):
        if len(shape) != ndim + 2:
            continue
        if shape[:2] == (ndim, ndim):
            return torch.stack([t[j, i] for i, j in sym_pairs(ndim)]).contiguous()
        if shape[-2:] == (ndim, ndim):
            return torch.stack([t[..., j, i] for i, j in sym_pairs(ndim)]).contiguous()
    raise ValueError(f"cannot interpret shape {shape} as a symmetric 2D/3D tensor field")


def sym_to_matrix(planes: torch.Tensor) -> torch.Tensor:
    """``(S, *shape)`` stack (or a sequence of S planes) -> the symmetric
    ``(D, D, *shape)`` matrix field."""
    ndim = {3: 2, 6: 3}[len(planes)]
    return torch.stack([torch.stack([planes[sym_index(ndim, i, j)] for j in range(ndim)])
                        for i in range(ndim)])


def _as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def as_sym_planes(tensor, grid_shape: Tuple[int, ...], dtype=None,
                  device=None) -> torch.Tensor:
    """Canonicalize a user-provided tensor field to the ``(S, *shape)`` stack.

    Accepts a stack or a tuple/list of ``S = D(D+1)/2`` planes of
    ``grid_shape``, or a full matrix field in ``(D, D, *shape)`` /
    ``(*shape, D, D)`` layout, of which only the lower triangle is read (as
    the reference filter's SetDiffusionTensor does).  Numpy arrays and
    torch tensors are both accepted.
    """
    grid_shape = tuple(grid_shape)
    ndim = len(grid_shape)
    s = sym_size(ndim)
    if isinstance(tensor, (tuple, list)):
        if len(tensor) != s:
            raise ValueError(
                f"expected {s} tensor planes for {ndim}D, got {len(tensor)}"
            )
        planes = [_as_tensor(p, dtype, device) for p in tensor]
        for p in planes:
            if tuple(p.shape) != grid_shape:
                raise ValueError(
                    f"tensor plane shape {tuple(p.shape)} != grid shape {grid_shape}"
                )
        return torch.stack(planes).contiguous()
    t = _as_tensor(tensor, dtype, device)
    t_shape = tuple(t.shape)
    if t_shape == (s, *grid_shape):
        return t.contiguous()
    if t_shape == (ndim, ndim, *grid_shape):
        return torch.stack([t[j, i] for i, j in sym_pairs(ndim)]).contiguous()
    if t_shape == (*grid_shape, ndim, ndim):
        return torch.stack([t[..., j, i] for i, j in sym_pairs(ndim)]).contiguous()
    raise ValueError(
        f"tensor shape {t_shape} does not match image shape {grid_shape}: expected "
        f"{(s, *grid_shape)}, {(ndim, ndim, *grid_shape)}, "
        f"{(*grid_shape, ndim, ndim)}, or a tuple of {s} planes"
    )

