"""The least time of a multigrid solve's stencil work on its stored levels,
behind ``kernels.stored_roofline``: the Galerkin levels ``1 .. L-2`` of a
hierarchy whose level 0 is the compressed operator (:mod:`.workcount` counts
that one) and whose coarsest level is the dense solve.

The count is of the algorithm, as :mod:`.workcount`'s is, so a fused sweep
raises the share and cannot push it past 100%.  Per V-cycle visit of a
stored level, its ``nu`` pre- and ``nu`` post-smoothing sweeps and its
residual read the operator's planes, ``b`` and ``x`` once down and once up
and write ``x`` once, at the precision the cycle ran in
(:func:`.workcount.cycle_bytes`).  Operations per cell: a sweep multiplies
and adds each off-centre plane's term, subtracts the sum from ``b`` and
divides by the diagonal; the residual adds ``diag * x`` and two
subtractions.  The transfers (B3/B4) and the coarsest solve are not stencil
work.  A visit's least time is the larger of its bytes over the card's
bandwidth and its operations over its float32 rate (:mod:`.workcount`'s
peaks).

:func:`is_stored_kernel` names the launches whose time the count is held
to: B12, the tile march ``mad::tile::tile_kernel`` instantiated with the
stored operator's contraction ``Taps`` (B1/B2 instantiate it with
``Compressed``).
"""

from __future__ import annotations

import math
from typing import Sequence

from . import workcount as wc

#: planes of a collapsed Galerkin level: the full 3x3x3 stencil
PLANES_COLLAPSED = 27


def sweep_flops(planes: int) -> int:
    """Per cell and full sweep."""
    return 2 * (planes - 1) + 2


def residual_flops(planes: int) -> int:
    """Per cell."""
    return 2 * (planes - 1) + 3


def visit_seconds(shape: Sequence[int], nu: int, planes: int, value_bytes: int) -> float:
    """Least time of one V-cycle visit's stencil work on a stored level."""
    n = math.prod(shape)
    moved = (2 * (planes + 2) + 1) * n * value_bytes
    flops = (2 * nu * sweep_flops(planes) + residual_flops(planes)) * n
    return max(moved / wc.HBM_BYTES_PER_S, flops / wc.FP32_FLOPS_PER_S)


def cycle_seconds(shape: Sequence[int], nu: int, planes: int, value_bytes: int) -> float:
    """One V-cycle from level 0 of the hierarchy over ``shape``: a visit of
    every stored level ``1 .. L-2``."""
    levels = wc.level_shapes(shape)
    return sum(visit_seconds(lvl, nu, planes, value_bytes) for lvl, _ in levels[1:-1])


def step_seconds(shape: Sequence[int], nu: int, planes: int,
                 cycle_value_bytes: Sequence[int]) -> float:
    """One implicit step whose inner cycles ran at ``cycle_value_bytes``."""
    return sum(cycle_seconds(shape, nu, planes, vb) for vb in cycle_value_bytes)


def is_stored_kernel(name: str) -> bool:
    """A device operation's name is one of B12's launches."""
    return "tile_kernel" in name and "Taps<" in name
