"""Plain PyTorch reference of the Galerkin coarse operators: the upstream's
GCA option (``CoarseGridOperatorType{DCA, GCA}``,
``itkMultigridAnisotropicDiffusionImageFilter.h:27,67-69``; the generator in
``doc/html/itk_coarse_grid_operators_generator_8h_source.html``), in its
parabolic form ``A_c = I - R (I - A_f) P`` and with the coarse stencil
collapsed onto radius 1.

The transfers are tensor products of 1-D stencils (coarse index ``j``, fine
index ``i``), from ``itkInterGridOperators.h:101-127``:

* restriction, vertex (fine ``2c - 1`` -> coarse ``c``): ``[1/4, 1/2, 1/4]``
  on ``2j - 1 .. 2j + 1``, injection on the first and last points;
* restriction, cell (fine ``2c`` -> coarse ``c``): ``[1/8, 3/8, 3/8, 1/8]`` on
  ``2j - 1 .. 2j + 2``, a tap off the grid read from the border point (the
  border rows ``[1/2, 3/8, 1/8]`` and ``[1/8, 3/8, 1/2]``);
* interpolation, vertex: coarse ``j`` spreads ``[1/2, 1, 1/2]`` onto
  ``2j - 1 .. 2j + 1`` (the parts off the grid dropped);
* interpolation, cell: coarse ``j`` spreads ``[1/4, 3/4, 3/4, 1/4]`` onto
  ``2j - 1 .. 2j + 2``; a fine point reads a coarse point off the grid from
  the border point, so the first and last fine points copy theirs.

An even fine size is coarsened cell-centred, an odd one vertex-centred
(``itkGridsHierarchy.hxx:84-97``).  An operator is a dict from offset
``(dz, dy, dx)`` to its coefficient plane: row ``J`` of the operator holds
``plane[J]`` in column ``J + offset``, and a coefficient whose column leaves
the grid is zero.  The level-0 operator is :mod:`.solve`'s 19-point DCA
stencil.

The product is built in two ways:

* :func:`galerkin_dense` (:func:`coarsen_dense` for ``R S P``), with the
  operator, ``R`` and ``P`` as dense matrices (Kronecker products of the 1-D
  ones): for test sizes;
* :func:`galerkin_probe` (:func:`coarsen`), by comb probing at any size: a
  probe is 1 on every coarse point of one residue class modulo ``2 reach +
  1`` per axis, where ``reach`` bounds the coarse stencil's radius, so ``R S
  P`` of a probe holds one coefficient of every row, with no two columns
  mixed.  The probes run in batches along a leading axis through the dense
  1-D transfers.

It is meant for float64, in which TF32 never replaces a product.

Departures from the upstream GCA:

* the parabolic form: the upstream coarsens ``A_f`` itself (``R A_f P``);
  here only the spatial part ``S = I - A_f`` is coarsened and the identity
  stays exact on every level, since the literal product loses diagonal
  dominance down deep chains;
* the collapse, which the upstream does not have: each coefficient of the
  coarse ``S`` is lumped onto its component-wise clipped offset, which keeps
  every row sum and leaves a full radius-1 stencil of 27 planes;
* the borders: the upstream writes out border cases of the product by hand
  (``..._8hxx_source.html:610-778``); here they are whatever the product of
  the transfers' own border rows gives.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import solve

Offset = Tuple[int, int, int]
Operator = Dict[Offset, torch.Tensor]
CENTRE = (0, 0, 0)
CELL, VERTEX = "cell", "vertex"


def centring(fine_n: int) -> str:
    return CELL if fine_n % 2 == 0 else VERTEX


def coarse_size(fine_n: int) -> int:
    return fine_n // 2 if fine_n % 2 == 0 else (fine_n - 1) // 2 + 1


def restriction_1d(fine_n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The ``(coarse, fine)`` matrix of the 1-D restriction."""
    c = coarse_size(fine_n)
    r = torch.zeros((c, fine_n), dtype=dtype, device=device)
    if centring(fine_n) == VERTEX:
        r[0, 0] = r[c - 1, fine_n - 1] = 1.0
        for j in range(1, c - 1):
            for i, w in zip((2 * j - 1, 2 * j, 2 * j + 1), (0.25, 0.5, 0.25)):
                r[j, i] += w
    else:
        for j in range(c):
            for i, w in zip(range(2 * j - 1, 2 * j + 3), (0.125, 0.375, 0.375, 0.125)):
                r[j, min(max(i, 0), fine_n - 1)] += w
    return r


def prolongation_1d(fine_n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The ``(fine, coarse)`` matrix of the 1-D interpolation."""
    c = coarse_size(fine_n)
    p = torch.zeros((fine_n, c), dtype=dtype, device=device)
    if centring(fine_n) == VERTEX:
        for j in range(c):
            for i, w in zip((2 * j - 1, 2 * j, 2 * j + 1), (0.5, 1.0, 0.5)):
                if 0 <= i < fine_n:
                    p[i, j] += w
    else:
        for i in range(fine_n):
            j = i // 2
            near = j - 1 if i % 2 == 0 else j + 1
            p[i, j] += 0.75
            p[i, min(max(near, 0), c - 1)] += 0.25
    return p


def transfer(v: torch.Tensor, mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """The matrices applied along the trailing ``len(mats)`` axes of ``v``,
    one axis at a time."""
    lead = v.dim() - len(mats)
    for d, m in enumerate(mats):
        axis = lead + d
        v = torch.movedim(torch.tensordot(m, v, dims=([1], [axis])), 0, axis)
    return v


def from_planes(c: torch.Tensor) -> Operator:
    """:mod:`.solve`'s ``(19, Z, Y, X)`` planes as an operator (views)."""
    return {off: c[k] for k, off in enumerate(solve.OFFSETS)}


def spatial_part(a: Operator) -> Operator:
    """``S = I - A``."""
    s = {off: -plane for off, plane in a.items()}
    s[CENTRE] = s[CENTRE] + 1.0
    return s


def parabolic(s: Operator) -> Operator:
    """``A = I - S``."""
    return spatial_part(s)


def radii(op: Operator) -> Tuple[int, ...]:
    return tuple(max(abs(off[d]) for off in op) for d in range(3))


def apply(op: Operator, v: torch.Tensor, absolute: bool = False) -> torch.Tensor:
    """``op v`` for ``v`` of shape ``(B, Z, Y, X)``, ``v`` zero off the grid;
    with ``absolute``, the operator of the coefficients' magnitudes."""
    r = max(radii(op))
    shape = v.shape[1:]
    vp = F.pad(v, (r,) * 6)
    out = torch.zeros_like(v)
    for (dz, dy, dx), plane in op.items():
        view = vp[:, r + dz:r + dz + shape[0], r + dy:r + dy + shape[1],
                  r + dx:r + dx + shape[2]]
        out.addcmul_(plane.abs() if absolute else plane, view)
    return out


def _reach(fine_n: int, fine_radius: int) -> int:
    """The coarse stencil's radius along one axis: ``R`` row ``J`` and ``P``
    column ``J + O`` reach fine points ``2 J - 1 .. 2 J + 2`` (cell) or ``2 J
    - 1 .. 2 J + 1`` (vertex), so the fine operator of radius ``r`` joins them
    only for ``|O| <= (r + 3) // 2`` (cell) or ``(r + 2) // 2`` (vertex)."""
    return (fine_radius + 3) // 2 if centring(fine_n) == CELL else (fine_radius + 2) // 2


def _clip(off: Offset) -> Offset:
    return tuple(max(-1, min(1, o)) for o in off)


def collapse(op: Operator) -> Operator:
    """Each coefficient lumped onto its component-wise clipped offset."""
    out: Operator = {}
    for off, plane in op.items():
        t = _clip(off)
        out[t] = plane.clone() if t not in out else out[t] + plane
    return out


def coarsen(s: Operator, fine_shape: Sequence[int], collapsed: bool = False,
            batch: int = 8, absolute: bool = False) -> Operator:
    """``R S P`` (``R |S| P`` with ``absolute``) by comb probing, collapsed
    onto radius 1 if ``collapsed``.  Exact: every offset of the reach box,
    those that nothing reaches as zero planes."""
    fine_shape = tuple(int(n) for n in fine_shape)
    some = next(iter(s.values()))
    dtype, device = some.dtype, some.device
    coarse = tuple(coarse_size(n) for n in fine_shape)
    reach = tuple(_reach(n, r) for n, r in zip(fine_shape, radii(s)))
    mod = tuple(2 * r + 1 for r in reach)
    rmats = [restriction_1d(n, dtype, device) for n in fine_shape]
    pmats = [prolongation_1d(n, dtype, device) for n in fine_shape]
    # per axis: the offset each coarse index's row finds a probe of each
    # phase at, and the offset it is kept under
    offsets = [[[(p - j + r) % m - r for j in range(n)] for p in range(m)]
               for n, r, m in zip(coarse, reach, mod)]
    kept = [sorted({max(-1, min(1, o)) if collapsed else o for o in range(-r, r + 1)})
            for r in reach]
    masks = [torch.tensor([[[(max(-1, min(1, o)) if collapsed else o) == t for t in ts]
                            for o in row] for row in rows], dtype=dtype, device=device)
             for rows, ts in zip(offsets, kept)]  # (phase, index, kept offset)
    out = {t: torch.zeros(coarse, dtype=dtype, device=device)
           for t in itertools.product(*kept)}
    phases = list(itertools.product(*(range(m) for m in mod)))
    for start in range(0, len(phases), batch):
        group = phases[start:start + batch]
        e = torch.zeros((len(group), *coarse), dtype=dtype, device=device)
        for k, (pz, py, px) in enumerate(group):
            e[k, pz::mod[0], py::mod[1], px::mod[2]] = 1.0
        w = transfer(apply(s, transfer(e, pmats), absolute), rmats)
        del e
        mz, my, mx = (m[[p[d] for p in group]] for d, m in enumerate(masks))
        for tz, oz in enumerate(kept[0]):
            wz = w * mz[:, :, tz, None, None]
            for ty, oy in enumerate(kept[1]):
                wzy = wz * my[:, None, :, ty, None]
                for tx, ox in enumerate(kept[2]):
                    out[(oz, oy, ox)] += torch.einsum("kzyx,kx->zyx", wzy, mx[:, :, tx])
            del wz, wzy
        del w
    return out


def dense(op: Operator, shape: Sequence[int]) -> torch.Tensor:
    """The ``(N, N)`` matrix of ``op`` on a grid of ``shape``, rows and
    columns in row-major order."""
    shape = tuple(shape)
    n = shape[0] * shape[1] * shape[2]
    index = torch.arange(n).reshape(shape)
    some = next(iter(op.values()))
    m = torch.zeros((n, n), dtype=some.dtype)
    for off, plane in op.items():
        rows = [slice(max(0, -o), min(s, s - o)) for o, s in zip(off, shape)]
        cols = [slice(r.start + o, r.stop + o) for r, o in zip(rows, off)]
        m[index[tuple(rows)].reshape(-1), index[tuple(cols)].reshape(-1)] += (
            plane[tuple(rows)].reshape(-1).cpu())
    return m


def planes_of(m: torch.Tensor, shape: Sequence[int], reach: Sequence[int]) -> Operator:
    """The planes of a dense ``(N, N)`` matrix on a grid of ``shape``, every
    offset within ``reach``; raises if an entry lies beyond it."""
    shape = tuple(shape)
    index = torch.arange(m.shape[0]).reshape(shape)
    out: Operator = {}
    kept = torch.zeros_like(m, dtype=torch.bool)
    for off in itertools.product(*(range(-r, r + 1) for r in reach)):
        plane = torch.zeros(shape, dtype=m.dtype)
        rows = [slice(max(0, -o), min(s, s - o)) for o, s in zip(off, shape)]
        cols = [slice(r.start + o, r.stop + o) for r, o in zip(rows, off)]
        ri, ci = index[tuple(rows)].reshape(-1), index[tuple(cols)].reshape(-1)
        plane[tuple(rows)] = m[ri, ci].reshape(plane[tuple(rows)].shape)
        kept[ri, ci] = True
        out[off] = plane
    if torch.any(m[~kept] != 0):
        raise AssertionError("the product reaches beyond its stencil")
    return out


def coarsen_dense(s: Operator, fine_shape: Sequence[int], collapsed: bool = False) -> Operator:
    """``R S P`` (collapsed onto radius 1 if ``collapsed``) through dense
    matrices: every offset of the reach box."""
    fine_shape = tuple(int(n) for n in fine_shape)
    coarse = tuple(coarse_size(n) for n in fine_shape)
    r_mats = [restriction_1d(n) for n in fine_shape]
    p_mats = [prolongation_1d(n) for n in fine_shape]
    r = torch.kron(r_mats[0], torch.kron(r_mats[1], r_mats[2]))
    p = torch.kron(p_mats[0], torch.kron(p_mats[1], p_mats[2]))
    reach = tuple(_reach(n, rr) for n, rr in zip(fine_shape, radii(s)))
    s_c = planes_of(r @ dense(s, fine_shape) @ p, coarse, reach)
    return collapse(s_c) if collapsed else s_c


def galerkin_dense(a: Operator, fine_shape: Sequence[int], collapsed: bool = False) -> Operator:
    """``I - R (I - A) P`` (collapsed if asked) through dense matrices."""
    return parabolic(coarsen_dense(spatial_part(a), fine_shape, collapsed))


def galerkin_probe(a: Operator, fine_shape: Sequence[int], collapsed: bool = False,
                   batch: int = 8) -> Operator:
    """``I - R (I - A) P`` (collapsed if asked) by comb probing."""
    return parabolic(coarsen(spatial_part(a), fine_shape, collapsed, batch))


def level_shapes(shape: Sequence[int], depth: int) -> List[Tuple[int, ...]]:
    """The first ``depth + 1`` level shapes, finest first."""
    out = [tuple(int(n) for n in shape)]
    for _ in range(depth):
        out.append(tuple(coarse_size(n) for n in out[-1]))
    return out
