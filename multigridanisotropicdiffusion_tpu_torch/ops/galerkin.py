"""Galerkin (GCA) coarse-grid operator construction: ``A_c = R A_f P``.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.galerkin`` (the
reference's documented GCA option).  Two assembly paths:

* **closed-form plane arithmetic** (:mod:`.galerkin_direct`), for fine grids
  of at least :data:`DIRECT_MIN_FINE_VOXELS` voxels under ``method='auto'``;
* **comb probing** (below), for smaller grids.

``A_c`` is a stencil operator whose per-dimension radius follows from the
1-D supports: with fine radius ``r_A``, vertex coarsening gives ``(2 + r_A)
// 2`` and cell coarsening ``(3 + r_A) // 2``, so radii settle at 2 down any
chain (a vertex coarsening of a radius-2 operator has radius 2, not 1).

Comb probing: a probe is 1 on every coarse point congruent to a phase modulo
``m_d = 2 r_d + 1`` per dimension.  The columns of ``A_c`` it hits do not
overlap, so one ``restrict(apply(prolong(comb)))`` recovers one entry of
every row exactly, ``w_phase[J] = A_c[J, O]`` with ``O`` the offset in
``[-r, r]`` for which ``J + O`` has that phase.  Out-of-range couplings meet
no comb point, so border rows come out right with no special cases.  The
probes run in batches of :data:`PROBE_BATCH` along a leading axis (the JAX
package maps them with ``lax.map``), through the plain transfers.  A
matrix-free fine operator has no planes: it is always probed, through its
own ``apply``.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.grids import CELL
from ..core.stencil import StencilOperator, stencil_offsets
from .compressed import CompressedDCAOperator
from .matfree import MatrixFreeDCAOperator
from .transfer import coarse_size, prolong_plain, restrict_plain

#: probes per batch: bounds the probe memory at batch * fine volume.
PROBE_BATCH = 16

#: fine grids of at least this many voxels use the closed-form assembly
#: under method='auto' (probing costs prod(2r+1) fine-grid applies).
DIRECT_MIN_FINE_VOXELS = 1 << 18


def galerkin_offsets(centering: Sequence[str], fine_radii: Sequence[int]):
    """Full offset table and per-dimension radii of the Galerkin coarse
    operator: ``(2 + r) // 2`` under vertex centring, ``(3 + r) // 2`` under
    cell; no corners dropped."""
    radii = tuple(
        (3 + r) // 2 if c == CELL else (2 + r) // 2
        for c, r in zip(centering, fine_radii)
    )
    return tuple(itertools.product(*[range(-r, r + 1) for r in radii])), radii


def _structural_offsets(centering: Sequence[str], fine_offsets, radii):
    """The coarse offsets that can receive a contribution: ``O`` is
    reachable iff some fine offset ``a`` has ``2 O_d - a_d`` within the
    combined P/R 1-D support in every dimension jointly ([-3, 3] cell,
    [-2, 2] vertex).  The 19-point fine operator has no corners, so e.g.
    coarse (+-2, +-2, +-2) is dropped."""
    ndim = len(radii)
    span = tuple(3 if c == CELL else 2 for c in centering)
    out = []
    for off in itertools.product(*[range(-r, r + 1) for r in radii]):
        for a in fine_offsets:
            if all(abs(2 * off[d] - a[d]) <= span[d] for d in range(ndim)):
                out.append(off)
                break
    return tuple(out)


def _per_dim_radii(offsets):
    return tuple(max(abs(off[d]) for off in offsets) for d in range(len(offsets[0])))


class _SpatialPart:
    """``S = I - A`` (the ``dt*L`` part of ``A = I - dt*L``) as an operator,
    for Galerkin coarsening: same offsets, shape and dtype as ``A``."""

    def __init__(self, op):
        self._op = op
        self.ndim = op.ndim
        self.shape = op.shape

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return v - self._op.apply(v)


def _matrix_free(op) -> MatrixFreeDCAOperator | None:
    """The matrix-free operator behind ``op`` (itself or its spatial-part
    view), or None: it has no plane form, so it is probed through its own
    ``apply``, as the JAX package probes it."""
    inner = op._op if isinstance(op, _SpatialPart) else op
    return inner if isinstance(inner, MatrixFreeDCAOperator) else None


def plane_getter(op):
    """``(offsets, get)`` with ``get(k)`` the coefficient plane of
    ``offsets[k]``, for a stored or compressed operator or the spatial-part
    view.  A compressed operator's planes come in ``stencil_offsets`` order
    (19 in 3D, 9 in 2D), its mixed terms as ``s1*s2`` times their plane;
    views where a plane is stored, new tensors where it is computed."""
    if isinstance(op, StencilOperator):
        return op.offsets, lambda k: op.coeffs[k]
    if isinstance(op, _SpatialPart):
        offsets, get = plane_getter(op._op)
        center = offsets.index((0,) * len(offsets[0]))
        return offsets, lambda k: 1.0 + -get(k) if k == center else -get(k)
    if isinstance(op, CompressedDCAOperator):
        ndim = op.ndim
        planes = op.planes
        terms = {(0,) * ndim: (1.0, -1)}
        for d in range(ndim):
            e = [0] * ndim
            e[d] = 1
            terms[tuple(e)] = (1.0, 2 * d)
            e[d] = -1
            terms[tuple(e)] = (1.0, 2 * d + 1)
        k = 0
        for d in range(ndim):
            for d2 in range(d + 1, ndim):
                for s1 in (1, -1):
                    for s2 in (1, -1):
                        off = [0] * ndim
                        off[d] = s1
                        off[d2] = s2
                        terms[tuple(off)] = (float(s1 * s2), 2 * ndim + k)
                k += 1
        offsets = stencil_offsets(ndim)
        order = [terms[off] for off in offsets]

        def get(i):
            sign, p = order[i]
            return planes[p] if sign == 1.0 else sign * planes[p]

        return offsets, get
    raise TypeError(f"no stored plane form for {type(op).__name__}")


def stored_plane_terms(op):
    """``(offsets, planes)``: one materialized coefficient plane per offset
    (see :func:`plane_getter`)."""
    offsets, get = plane_getter(op)
    return offsets, tuple(get(k) for k in range(len(offsets)))


def collapse_to_radius1(op: StencilOperator) -> StencilOperator:
    """Lump every coefficient onto its component-wise clipped offset
    (AMG-style stencil collapsing).  Row sums are kept exactly, and so are
    the zero coefficients of out-of-range offsets: if ``J + clip(O)`` leaves
    the grid, so does ``J + O``.  The result is a full radius-1 stencil (27
    points in 3D).  The ``galerkin_variant='collapsed'`` path."""
    if op.radius <= 1:
        return op
    acc = {}
    for off, plane in zip(op.offsets, op.coeffs):
        tgt = tuple(max(-1, min(1, o)) for o in off)
        if tgt in acc:
            acc[tgt] += plane
        else:
            acc[tgt] = plane.clone()
    offsets = tuple(off for off in stencil_offsets(op.ndim, 1, drop_corners=False)
                    if off in acc)
    return StencilOperator(torch.stack([acc.pop(off) for off in offsets]), offsets)


def prune_stored_operator(op: StencilOperator, tol: float) -> StencilOperator:
    """Drop the planes whose ``max |c| < tol * max |diag|``, lumping each
    onto its clipped radius-1 offset (row sums exact, as in
    :func:`collapse_to_radius1`).  ``tol=0`` returns ``op``.

    The keep decision reads the K per-plane maxima on the host: one
    device-to-host transfer."""
    if tol <= 0 or op.radius <= 1:
        return op
    maxes = torch.stack([c.abs().max() for c in op.coeffs]).cpu().numpy()
    center = op.center_index
    floor = float(tol) * float(maxes[center])
    zero = (0,) * op.ndim
    acc = {}
    for k, (off, plane) in enumerate(zip(op.offsets, op.coeffs)):
        if not (k == center or off == zero or maxes[k] >= floor):
            off = tuple(max(-1, min(1, o)) for o in off)
        if off in acc:
            acc[off] += plane
        else:
            acc[off] = plane.clone()
    # deterministic order: original offsets first, then new lump targets
    offsets = [off for off in op.offsets if off in acc]
    offsets += [off for off in acc if off not in set(offsets)]
    return StencilOperator(torch.stack([acc.pop(off) for off in offsets]),
                           tuple(offsets))


def _resolve_method(fine_op, method: str) -> str:
    if method == "auto":
        if _matrix_free(fine_op) is not None:
            return "probe"
        voxels = 1
        for s in fine_op.shape:
            voxels *= s
        return "direct" if voxels >= DIRECT_MIN_FINE_VOXELS else "probe"
    if method not in ("probe", "direct"):
        raise ValueError(f"unknown Galerkin assembly method: {method!r}")
    return method


def assemble_galerkin_parabolic(fine_op, centering: Sequence[str],
                                probe_batch: int = PROBE_BATCH,
                                method: str = "auto",
                                collapse: bool = False) -> StencilOperator:
    """Galerkin-coarsen the spatial part of the implicit-Euler operator:
    ``A_c = I - R (I - A_f) P`` (exact identity + Galerkin ``dt*L``).

    The literal ``R A_f P`` loses diagonal dominance down deep chains (the
    identity's image ``R P`` smears off-diagonal mass that compounds per
    level), and coloured Gauss-Seidel diverges on such operators; keeping
    the identity exact on every level keeps row sums 1 and the smoothers
    contractive.

    ``fine_op``: a stored, compressed or matrix-free operator; returns a
    stored one.
    ``method``: 'probe', 'direct' or 'auto' (direct from
    :data:`DIRECT_MIN_FINE_VOXELS` fine voxels).  ``collapse`` lumps the
    coarsened ``dt*L`` onto radius 1 (:func:`collapse_to_radius1`) before
    the identity is added back."""
    s_c = assemble_galerkin(_SpatialPart(fine_op), centering, probe_batch, method)
    if collapse:
        s_c = collapse_to_radius1(s_c)
    coeffs = s_c.coeffs.neg_()
    coeffs[s_c.center_index] += 1.0
    return StencilOperator(coeffs, s_c.offsets)


def _contract_batched(offsets, planes, v: torch.Tensor) -> torch.Tensor:
    """``A v`` for a batch ``v`` of shape ``(B, *shape)`` (zero padding)."""
    r = max(abs(o) for off in offsets for o in off)
    vp = F.pad(v, (r, r) * len(offsets[0]))  # the grid axes only
    out = None
    for off, plane in zip(offsets, planes):
        view = vp[(slice(None),) + tuple(slice(r + o, r + o + s)
                                         for o, s in zip(off, v.shape[1:]))]
        term = plane * view
        out = term if out is None else out + term
    return out


def assemble_galerkin(fine_op, centering: Sequence[str],
                      probe_batch: int = PROBE_BATCH,
                      method: str = "auto") -> StencilOperator:
    """The literal triple product ``A_c = R A_f P`` on the next coarser grid
    (:func:`assemble_galerkin_parabolic` is the implicit-Euler form)."""
    ndim = fine_op.ndim
    fine_shape = tuple(fine_op.shape)
    coarse_shape = tuple(coarse_size(s, c) for s, c in zip(fine_shape, centering))
    matfree = _matrix_free(fine_op)
    fine_offsets, get = (matfree.offsets, None) if matfree else plane_getter(fine_op)
    offsets, radii = galerkin_offsets(centering, _per_dim_radii(fine_offsets))
    offsets = _structural_offsets(centering, fine_offsets, radii)

    if _resolve_method(fine_op, method) == "direct":
        if matfree:
            raise TypeError("the matrix-free operator has no plane form: it is probed")
        from .galerkin_direct import assemble_galerkin_direct

        return assemble_galerkin_direct(fine_offsets, get, tuple(centering),
                                        offsets, radii)

    if matfree:
        apply = fine_op.apply
        dtype, device = matfree.tensor.dtype, matfree.tensor.device
    else:
        planes = [get(k) for k in range(len(fine_offsets))]
        dtype, device = planes[0].dtype, planes[0].device

        def apply(v):
            return _contract_batched(fine_offsets, planes, v)
    moduli = tuple(2 * r + 1 for r in radii)
    coords = [
        torch.arange(s, device=device).reshape([-1 if d == i else 1 for i in range(ndim)])
        for d, s in enumerate(coarse_shape)
    ]
    phases = list(itertools.product(*[range(m) for m in moduli]))

    # one probe per phase, in batches along a leading axis: each batch reads
    # the fine planes once for up to probe_batch probes
    w_parts = []
    for start in range(0, len(phases), probe_batch):
        batch = phases[start:start + probe_batch]
        combs = []
        for phase in batch:
            comb = None
            for d in range(ndim):
                hit = (coords[d] % moduli[d]) == phase[d]
                comb = hit if comb is None else comb & hit
            combs.append(comb.expand(coarse_shape))
        v = torch.stack(combs).to(dtype)
        w_parts.append(restrict_plain(apply(prolong_plain(v, centering)), centering))
    w_stack = torch.cat(w_parts)  # (prod(m), *coarse_shape)

    # gather planes: plane_O[J] = W[phase(J + O)][J]
    strides = []
    acc = 1
    for m in reversed(moduli):
        strides.append(acc)
        acc *= m
    strides = tuple(reversed(strides))
    coeffs = torch.empty((len(offsets), *coarse_shape), dtype=dtype, device=device)
    for k, off in enumerate(offsets):
        idx = None
        for d in range(ndim):
            term = ((coords[d] + off[d]) % moduli[d]) * strides[d]
            idx = term if idx is None else idx + term
        idx = idx.expand(coarse_shape)
        coeffs[k] = torch.gather(w_stack, 0, idx[None])[0]
    return StencilOperator(coeffs, offsets)
