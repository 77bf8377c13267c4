"""The planes of a Galerkin hierarchy's levels and the least bytes of its
products, behind ``kernels.galerkin_roofline`` and
``kernels.exact_stored_roofline``.

Planes per level, counted from the stencils' structure (the operator of
level 0 is the compressed 19-point one, :data:`.workcount.PLANES_3D`
planes as stored): along a cell-centred axis a coarse row ``J`` restricts
fine points ``2 J - 1 .. 2 J + 2`` and column ``J + O`` interpolates onto
fine points ``2 (J + O) - 1 .. 2 (J + O) + 2``, so a fine offset ``a``
reaches the coarse offsets ``O`` with ``|2 O - a| <= 3``.  From the
19-point stencil that is the 5^3 box less its eight corners, which would
need a fine corner: 117 planes on level 1 of the exact variant, and 125 on
every level below it.  The collapsed variant lumps each level onto the 3^3
box: 27 planes.

The least bytes of the product that makes level ``l + 1`` from level ``l``
(B16): the fine operator's planes read once and the coarse planes written
once, at the setup's precision.  Bytes only, as ``PERF.md``'s B16 row
counts them, so that no way of computing the same product can read above
100%.  A product's least time is its bytes over the card's bandwidth
(:data:`.workcount.HBM_BYTES_PER_S`).

:func:`exact_step_seconds` is ``workcount_stored.step_seconds`` on the
exact variant's levels 1 .. L-2, each visit at its own level's plane count.

:func:`is_product_kernel` names B16's launches (``galerkin_product_kernel``
in ``csrc/galerkin_product.cu``), in every form.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence

from . import workcount as wc
from . import workcount_stored as ws

COLLAPSED, EXACT = "collapsed", "exact"


def _dca_offsets():
    """The 19-point stencil: offsets of radius 1 with at most two non-zero
    components."""
    return {off for off in itertools.product((-1, 0, 1), repeat=3)
            if sum(o != 0 for o in off) <= 2}


def _reached(fine) -> set:
    """The coarse offsets a cell-centred product reaches from the fine
    offsets ``fine``."""
    return {off for off in itertools.product(range(-2, 3), repeat=3)
            if any(all(abs(2 * o - x) <= 3 for o, x in zip(off, a)) for a in fine)}


def level_planes(shape: Sequence[int], variant: str) -> List[int]:
    """Planes of every level's operator, level 0 first (as stored: the
    compressed operator's), for a hierarchy over ``shape`` whose coarse
    levels are all cell-centred; ``ValueError`` for one that is not."""
    if variant not in (COLLAPSED, EXACT):
        raise ValueError(f"unknown Galerkin variant: {variant!r}")
    levels = wc.level_shapes(shape)
    if any(c != wc.CELL for _, cent in levels[1:] for c in cent):
        raise ValueError(f"the count takes cell-centred levels only: {shape}")
    planes, offsets = [wc.PLANES_3D], _dca_offsets()
    for _ in levels[1:]:
        offsets = _reached(offsets)
        if variant == COLLAPSED:
            offsets = {tuple(max(-1, min(1, o)) for o in off) for off in offsets}
        planes.append(len(offsets))
    return planes


def product_bytes(shape: Sequence[int], variant: str, value_bytes: int) -> List[int]:
    """Least bytes of each level's product, level 1 first."""
    levels = wc.level_shapes(shape)
    planes = level_planes(shape, variant)
    return [(planes[l] * math.prod(levels[l][0]) + planes[l + 1] * math.prod(levels[l + 1][0]))
            * value_bytes for l in range(len(levels) - 1)]


def setup_seconds(shape: Sequence[int], variant: str, value_bytes: int) -> float:
    """Least time of one hierarchy's products."""
    return sum(product_bytes(shape, variant, value_bytes)) / wc.HBM_BYTES_PER_S


def exact_cycle_seconds(shape: Sequence[int], nu: int, value_bytes: int) -> float:
    """One V-cycle's least stencil time on the exact variant's stored levels
    ``1 .. L-2``, each at its own plane count."""
    levels = wc.level_shapes(shape)
    planes = level_planes(shape, EXACT)
    return sum(ws.visit_seconds(lvl, nu, p, value_bytes)
               for (lvl, _), p in zip(levels[1:-1], planes[1:-1]))


def exact_step_seconds(shape: Sequence[int], nu: int,
                       cycle_value_bytes: Sequence[int]) -> float:
    """One implicit step whose inner cycles ran at ``cycle_value_bytes``."""
    return sum(exact_cycle_seconds(shape, nu, vb) for vb in cycle_value_bytes)


def is_product_kernel(name: str) -> bool:
    """A device operation's name is one of B16's launches."""
    return "galerkin_product_kernel" in name
