"""The least time of a multigrid solve's algorithmic work on one card, behind
``kernels.solve_roofline``.

The count is of the algorithm, not of one implementation: it does not
change when kernels are fused, split or reordered.  The unit is one visit
of a level by the V-cycle:

* down: ``nu`` pre-smoothing sweeps, the residual and its restriction; the
  visit reads the operator and ``b`` once (``x`` starts from zero on every
  level of a defect cycle) and writes ``x`` and the coarse right-hand side
  once;
* up: the prolongation of the coarse correction added to ``x`` and ``nu``
  post-smoothing sweeps; it reads the operator, ``x``, ``b`` and the coarse
  correction once and writes ``x`` once;
* the coarsest level: the dense solve, one read of its inverse.

Each outer cycle of the mixed-precision defect correction adds its residual
in the solve precision: one read of the operator, ``x``, ``b`` and the
cycle's correction, one write of ``x`` and of the next cycle's defect (its
norm rides along).  Values are counted at the precision each cycle ran in:
inner cycles at the defect precision, except those the precision window
ran in full precision, which :func:`cycle_bytes` reads off the residual
history.

Operations are counted from the stencil's terms (per cell, the compressed
19-point operator: 6 face terms, 3 mixed terms over 4 neighbours each).  A
part's least time is the larger of its bytes over the card's bandwidth and
its operations over its float32 rate: the published peaks of an NVIDIA
H100 SXM at its full 700 W limit.  The levels follow a frozen copy of the
grid rule of ``itkGridsHierarchy.hxx`` (an even size halves to a
cell-centred level, an odd one to a vertex-centred one, down to 6 points).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
MIN_COARSE_SIZE = 6
BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}

#: per cell and full sweep: 6 face terms (multiply, add), 3 mixed terms (3
#: adds of their 4 neighbours, multiply, add), ``b - sum``, ``/ diag``
SWEEP_FLOPS = 6 * 2 + 3 * 5 + 2
#: per cell: the sweep's terms, ``diag * x`` and two subtractions
RESIDUAL_FLOPS = 6 * 2 + 3 * 5 + 3
CELL, VERTEX = "c", "v"
#: coefficient planes of the compressed 3D operator: 6 faces, 3 mixed, diagonal
PLANES_3D = 10


def level_shapes(shape: Sequence[int]) -> List[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """``(shape, centring)`` of every level, finest first; a level's
    centring says how it was coarsened from the one above (level 0: vertex)."""
    levels = [(tuple(shape), (VERTEX,) * len(shape))]
    while True:
        fine = levels[-1][0]
        coarse = tuple(s // 2 if s % 2 == 0 else (s - 1) // 2 + 1 for s in fine)
        if any(s < MIN_COARSE_SIZE for s in coarse):
            return levels
        levels.append((coarse, tuple(CELL if s % 2 == 0 else VERTEX for s in fine)))


def _transfer_flops(fine: Sequence[int], coarse: Sequence[int], centring: Sequence[str]) -> int:
    """Restriction (separable: 4 taps per axis cell-centred, 3 vertex) plus
    the prolongation (2 taps per axis) added to ``x``."""
    flops = 0
    size = list(fine)
    for d, c in enumerate(centring):  # restriction, axis by axis
        size[d] = coarse[d]
        flops += 2 * (4 if c == CELL else 3) * math.prod(size)
    size = list(coarse)
    for d in reversed(range(len(fine))):  # prolongation, axis by axis
        size[d] = fine[d]
        flops += 2 * 2 * math.prod(size)
    return flops + math.prod(fine)


def cycle_seconds(shape: Sequence[int], nu: int, planes: int, value_bytes: int,
                  coarse_bytes: int) -> float:
    """Least time of one defect V-cycle from level 0 at ``value_bytes`` per
    value (the operator too), the coarsest inverse at ``coarse_bytes``."""
    levels = level_shapes(shape)
    total = 0.0
    for l in range(len(levels) - 1):
        n = math.prod(levels[l][0])
        nc = math.prod(levels[l + 1][0])
        s = value_bytes
        down = planes * n * s + n * s + n * s + nc * s
        up = planes * n * s + 3 * n * s + nc * s
        flops = (2 * nu * SWEEP_FLOPS + RESIDUAL_FLOPS) * n + _transfer_flops(
            levels[l][0], levels[l + 1][0], levels[l + 1][1])
        total += max((down + up) / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
    nc = math.prod(levels[-1][0])
    coarsest = nc * nc * coarse_bytes + 2 * nc * value_bytes
    return total + max(coarsest / HBM_BYTES_PER_S, 2 * nc * nc / FP32_FLOPS_PER_S)


def cycle_bytes(history: Sequence[float], cycles: int, tolerance: float, switch: float,
                solve_bytes: int, defect_bytes: int) -> List[int]:
    """Bytes per value of each inner cycle of one step: the defect precision,
    or the solve precision where the previous cycle's relative residual
    ``r`` (compared in float32, as the solve compares it) lies in the window
    ``tolerance * switch / 20 < r <= tolerance * switch``; the first cycle
    follows no residual."""
    top = float(np.float32(tolerance * switch))
    bottom = float(np.float32(tolerance * (switch / 20.0)))
    out, prev = [], math.inf
    for k in range(cycles):
        out.append(solve_bytes if switch > 0 and bottom < prev <= top else defect_bytes)
        prev = float(history[k])
    return out


def step_seconds(shape: Sequence[int], nu: int, planes: int, cycle_value_bytes: Sequence[int],
                 solve_bytes: int) -> float:
    """Least time of one implicit step of the defect correction whose inner
    cycles ran at ``cycle_value_bytes``."""
    n = math.prod(shape)
    s = solve_bytes
    k = len(cycle_value_bytes)
    total = max((planes * n * s + n * s + n * cycle_value_bytes[0]) / HBM_BYTES_PER_S,
                RESIDUAL_FLOPS * n / FP32_FLOPS_PER_S) if k else 0.0
    for i, vb in enumerate(cycle_value_bytes):
        total += cycle_seconds(shape, nu, planes, vb, solve_bytes)
        nxt = cycle_value_bytes[i + 1] if i + 1 < k else 0
        outer = planes * n * s + 2 * n * s + n * vb + n * s + n * nxt
        total += max(outer / HBM_BYTES_PER_S, (RESIDUAL_FLOPS + 1) * n / FP32_FLOPS_PER_S)
    return total

