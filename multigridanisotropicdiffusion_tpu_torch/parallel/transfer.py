"""Transfers between levels of the distributed solve, on blocks.

No module of its own in the JAX package: there the restriction, the
prolongation and the coarsest solve run as global-view ops that XLA
partitions (``models.mad._standard_transfers`` and ``_padded_transfers``
under sharding constraints).  Here each is explicit:

* Both transfers are tensor products of 1-D operators given as per-axis
  tables, ``out[i] = sum_t w[i, t] in[start[i] + t]`` (``ops.transfer``).
  The global table of an axis covers the level's padded extent: the true
  rows come from the true shape's taps, the pad rows have weight 0, so pad
  cells stay 0 and the padded solve equals the unpadded one.
* A rank computes its output rows from the rows of the global table, after
  it has received the input rows it lacks from its neighbours (one
  exchange per split axis, each face carrying the earlier axes' halos, so
  the corners come along).  Coarse and fine blocks do not line up 2:1 on
  vertex-centred or padded levels (513 on 4 ranks: fine blocks of 129,
  coarse of 65), so the needed range is derived from the tables, and one
  hop is asserted to be enough.  The block then goes through the transfer
  kernel in one launch (``ops.cuda_transfer.restrict_block``,
  ``prolong_block``) with the starts shifted into the extended block, or
  through its plain version.
* Where the coarse level replicates an axis the fine one splits
  (agglomeration), each rank restricts one chunk of that axis and the
  chunks are gathered along the axis after the restriction; the
  prolongation from a replicated axis needs no communication.
* The coarsest solve runs replicated: the right-hand side is gathered,
  cropped to the true shape, solved, padded and cut back to the block.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.grids import GridLevel
from ..ops.coarse import coarse_solve
from ..ops.transfer import apply_taps_plain, prolong_taps, restrict_taps
from .padding import crop_field, pad_field
from .sharding import GridMesh, Spec, exchange_faces, gather_axis, gather_level, shard_field

RESTRICT = "restrict"
PROLONG = "prolong"


@functools.lru_cache(maxsize=256)
def _global_table(kind: str, fine_true: int, centering: str, out_size: int):
    """``(start, weights)`` over ``out_size`` rows: the true rows' taps, then
    pad rows with weight 0."""
    taps = restrict_taps if kind == RESTRICT else prolong_taps
    start, weights = taps(fine_true, centering)
    n = len(start)
    if out_size < n:
        raise ValueError(f"{out_size} output rows < {n} true rows")
    s = np.zeros(out_size, np.int64)
    w = np.zeros((out_size, weights.shape[1]))
    s[:n], w[:n] = start, weights
    return s, w


def _needed(start, weights, rows) -> Tuple[int, int] | None:
    """``[lo, hi)`` of the input rows that rows ``rows`` read with a
    non-zero weight (None if none does)."""
    lo, hi = None, None
    for i in range(*rows):
        nz = np.flatnonzero(weights[i])
        if nz.size:
            a, b = int(start[i] + nz[0]), int(start[i] + nz[-1]) + 1
            lo = a if lo is None else min(lo, a)
            hi = b if hi is None else max(hi, b)
    return None if lo is None else (lo, hi)


@dataclasses.dataclass(frozen=True)
class _Axis:
    """One rank's part of one axis of one transfer."""

    out_rows: Tuple[int, int]
    recv: Tuple[int, int]  # input rows received from the lower / upper neighbour
    send: Tuple[int, int]  # input rows sent to the lower / upper neighbour
    start: np.ndarray  # int32 starts into the extended input block
    weights: np.ndarray
    gather: int  # chunk length when the output is gathered along the axis, else 0


def _axis_plan(kind, fine_true, centering, in_size, out_size, in_split, out_split,
               p, c) -> _Axis:
    """Axis plan of the rank at mesh coordinate ``c`` of ``p``."""
    start, weights = _global_table(kind, fine_true, centering, out_size)

    def rows_of(cc):
        if out_split:
            q = out_size // p
            return cc * q, (cc + 1) * q
        if in_split:  # agglomeration: one chunk each, gathered after
            q = -(-out_size // p)
            return min(cc * q, out_size), min((cc + 1) * q, out_size)
        return 0, out_size

    def block_of(cc):
        if not in_split:
            return 0, in_size
        q = in_size // p
        return cc * q, (cc + 1) * q

    def recv_of(cc):
        f0, f1 = block_of(cc)
        need = _needed(start, weights, rows_of(cc))
        if need is None or not in_split:
            return 0, 0
        lo, hi = need
        r_lo, r_hi = max(0, f0 - lo), max(0, hi - f1)
        q = in_size // p
        if r_lo > q or r_hi > q or (r_lo and cc == 0) or (r_hi and cc == p - 1):
            raise AssertionError(
                f"{kind}: rank {cc} of {p} needs input rows [{lo}, {hi}) beyond one hop "
                f"of its block [{f0}, {f1})")
        return r_lo, r_hi

    o0, o1 = rows_of(c)
    r_lo, r_hi = recv_of(c)
    send = (recv_of(c - 1)[1] if c > 0 else 0, recv_of(c + 1)[0] if c < p - 1 else 0)
    e0 = block_of(c)[0] - r_lo
    ext = block_of(c)[1] - block_of(c)[0] + r_lo + r_hi
    local = np.clip(start[o0:o1] - e0, 0, max(ext - 1, 0)).astype(np.int32)
    gather = -(-out_size // p) if (in_split and not out_split) else 0
    return _Axis((o0, o1), (r_lo, r_hi), send, local, weights[o0:o1], gather)


class Layout(NamedTuple):
    """A level as the distributed solve holds it: its true shape, the padded
    embedding and the split (``spec``)."""

    shape: Tuple[int, ...]
    pshape: Tuple[int, ...]
    spec: Spec


class BlockTransfers:
    """``restrict(r, fine_level)``, ``prolong(e, fine_level)``,
    ``solve_coarse(solver, b, level)`` and ``prolong_add(x, e, fine_level)``
    (``x + prolong(e)``) on this rank's blocks; the counterpart of
    ``models.mad.Transfers`` under a mesh."""

    def __init__(self, mesh: GridMesh, levels: Sequence[GridLevel],
                 layouts: Sequence[Layout], use_kernels: bool = False):
        self.mesh = mesh
        self.levels = tuple(levels)
        self.layouts = tuple(layouts)
        self.use_kernels = use_kernels
        self._plans = {}
        self._tables = {}  # the kernels' tables on the device, per level and dtype

    def _plan(self, kind: str, fl: int):
        key = (kind, fl)
        if key not in self._plans:
            fine, coarse = self.layouts[fl], self.layouts[fl + 1]
            src, dst = (fine, coarse) if kind == RESTRICT else (coarse, fine)
            cent = self.levels[fl + 1].centering
            plan = []
            for d in range(len(fine.shape)):
                p = self.mesh.shape[d]
                plan.append(_axis_plan(
                    kind, fine.shape[d], cent[d], src.pshape[d], dst.pshape[d],
                    src.spec[d] is not None and p > 1, dst.spec[d] is not None and p > 1,
                    p, self.mesh.coords[d]))
            self._plans[key] = tuple(plan)
        return self._plans[key]

    def _apply(self, kind: str, x: torch.Tensor, fl: int) -> torch.Tensor:
        plan = self._plan(kind, fl)
        for d, ax in enumerate(plan):
            if not (any(ax.recv) or any(ax.send)):
                continue
            shape = list(x.shape)
            lo_shape, hi_shape = list(shape), list(shape)
            lo_shape[d], hi_shape[d] = ax.recv
            n = shape[d]
            from_lo, from_hi = exchange_faces(
                self.mesh, d, x.narrow(d, 0, ax.send[0]),
                x.narrow(d, n - ax.send[1], ax.send[1]), lo_shape, hi_shape,
                x.dtype, x.device)
            x = torch.cat([t for t in (from_lo, x, from_hi) if t is not None], dim=d)
        tables = tuple((ax.start, ax.weights) for ax in plan)
        if self.use_kernels and x.dim() == 3:
            from ..ops import cuda_transfer

            key = (kind, fl, x.dtype, x.device)
            if key not in self._tables:
                self._tables[key] = cuda_transfer.BlockTables(
                    tables, 4 if kind == RESTRICT else 2, x.dtype, x.device)
            fn = cuda_transfer.restrict_block if kind == RESTRICT else cuda_transfer.prolong_block
            out = fn(x.contiguous(), self._tables[key])
        else:
            out = apply_taps_plain(x, tables, range(x.dim()) if kind == RESTRICT
                                   else reversed(range(x.dim())))
        for d, ax in enumerate(plan):
            if ax.gather:
                rows = out.shape[d]
                if rows < ax.gather:
                    pad = list(out.shape)
                    pad[d] = ax.gather - rows
                    out = torch.cat([out, out.new_zeros(pad)], dim=d)
                out = gather_axis(out, self.mesh, d)
                total = self.layouts[fl + 1 if kind == RESTRICT else fl].pshape[d]
                out = out.narrow(d, 0, total)
        return out.contiguous()

    def restrict(self, r: torch.Tensor, fl: int) -> torch.Tensor:
        return self._apply(RESTRICT, r, fl)

    def prolong(self, e: torch.Tensor, fl: int) -> torch.Tensor:
        return self._apply(PROLONG, e, fl)

    def prolong_add(self, x: torch.Tensor, e: torch.Tensor, fl: int) -> torch.Tensor:
        return x + self.prolong(e, fl)

    def solve_coarse(self, solver, b: torch.Tensor, level: int) -> torch.Tensor:
        lay = self.layouts[level]
        full = crop_field(gather_level(b, self.mesh, lay.spec), lay.shape)
        x = pad_field(coarse_solve(solver, full.contiguous()), lay.pshape)
        return shard_field(x, self.mesh, spec=lay.spec)
