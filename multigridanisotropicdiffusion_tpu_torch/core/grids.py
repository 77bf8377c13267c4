"""Grid-hierarchy metadata: level shapes, spacings and per-dimension centering.

A copy of ``multigridanisotropicdiffusion_tpu.core.grids`` (pure Python;
importing it from the JAX package would import jax).  It mirrors the level
bookkeeping of the reference's ``mad::GridsHierarchy``
(include/mad/itkGridsHierarchy.hxx:36-106):

* coarsening rule per dimension: an even size ``s`` coarsens to ``s/2`` and the
  coarse grid is *cell*-centered in that dimension; an odd size coarsens to
  ``(s-1)/2 + 1`` and the coarse grid is *vertex*-centered,
* the hierarchy stops before any dimension would drop below 6 points,
* spacing doubles at every level.

Everything here is static host-side metadata (plain Python dataclasses): the
cycle driver walks the level list on the host, and every level array has a
fixed shape.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

VERTEX = "v"
CELL = "c"

#: Minimum grid points per dimension on the coarsest level (reference
#: itkGridsHierarchy.hxx:50 stops once a halved dimension is < 6).
MIN_COARSE_SIZE = 6


def coarsen_size(s: int) -> int:
    """Coarse size of one dimension (itkGridsHierarchy.hxx:48)."""
    return s // 2 if s % 2 == 0 else (s - 1) // 2 + 1


def coarsen_centering(s: int) -> str:
    """Centering of the coarse grid along a dimension of fine size ``s``.

    Even fine size -> cell-centered coarse dimension; odd -> vertex-centered
    (itkGridsHierarchy.hxx:84-97).
    """
    return CELL if s % 2 == 0 else VERTEX


@dataclasses.dataclass(frozen=True)
class GridLevel:
    """Static descriptor of one level of the multigrid hierarchy.

    ``centering[d]`` describes how *this* level was obtained from the next finer
    one (meaningless for level 0, set to all-vertex by convention, mirroring
    itkGridsHierarchy.hxx:67).
    """

    shape: Tuple[int, ...]
    spacing: Tuple[float, ...]
    centering: Tuple[str, ...]
    index: int

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def num_points(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def build_level_descriptors(
    shape: Tuple[int, ...], spacing: Tuple[float, ...] | None = None
) -> Tuple[GridLevel, ...]:
    """Compute the full level list for a fine grid of ``shape``.

    Reproduces the depth rule of itkGridsHierarchy.hxx:36-59: levels are added
    while the *new* (coarser) shape still has every dimension >= 6; the first
    halving that would produce a dimension < 6 is rejected.
    """
    ndim = len(shape)
    if spacing is None:
        spacing = (1.0,) * ndim
    if len(spacing) != ndim:
        raise ValueError(f"spacing rank {len(spacing)} != shape rank {ndim}")
    if any(s < 1 for s in shape):
        raise ValueError(f"invalid shape {shape}")

    levels = [
        GridLevel(
            shape=tuple(shape),
            spacing=tuple(float(h) for h in spacing),
            centering=(VERTEX,) * ndim,
            index=0,
        )
    ]
    while True:
        prev = levels[-1]
        new_shape = tuple(coarsen_size(s) for s in prev.shape)
        if any(ns < MIN_COARSE_SIZE for ns in new_shape):
            break
        levels.append(
            GridLevel(
                shape=new_shape,
                spacing=tuple(h * 2.0 for h in prev.spacing),
                centering=tuple(coarsen_centering(s) for s in prev.shape),
                index=prev.index + 1,
            )
        )
    return tuple(levels)


def max_depth(levels: Tuple[GridLevel, ...]) -> int:
    """Index of the coarsest level (reference GetMaxDepth())."""
    return len(levels) - 1
