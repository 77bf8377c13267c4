"""Closed-form Galerkin coarse-operator assembly: ``A_c = R A_f P`` as direct
plane arithmetic (no probing).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.galerkin_direct``.
The transfers are tensor products of 1-D stencils and the fine operator is a
stencil, so every coarse coefficient plane is a sum of separable 1-D banded
contractions of the fine coefficient planes:

    A_c[J, J+O] = sum_a sum_i prod_d R_d[J_d, i_d]
                                * coeff_a[i] * prod_d P_d[i_d + a_d, J_d + O_d]

With the per-dimension pair kernels ``G_d^{a,O}[J, i] = R_d[J, i] P_d[i+a,
J+O]`` (zero outside index ranges),
``plane_O = sum_a (G_0^{a_0,O_0} (x) G_1^{a_1,O_1} (x) ...) coeff_a``.

Each ``G`` is a stride-2 banded matrix: Toeplitz in its interior (``out[j] =
sum_p g(p) u[2j+p]``) with a few border rows inherited from the transfers'
border stencils.  :func:`analyze_banded` detects that structure numerically
from the exact (dyadic-rational) entries, so the borders are the transfers'
own; :func:`apply_banded` applies it with strided slices along one axis.
The fan-out over ``(a, O)`` pairs is batched by stacking planes on a leading
axis, one spatial axis at a time, grouped by the fine offset's component
along that axis, with sum factorisation between the axes.

Unlike the JAX package, the interiors are always strided slices: its
``_interior_conv`` is a TPU code-generation workaround with the same
arithmetic (only the summation order could differ).  The output planes are
accumulated in place into one preallocated ``(K, *coarse_shape)`` tensor, so
each first-axis chunk's intermediates are freed before the next; fine grids
of up to :data:`ONE_PASS_VOXELS` take one pass, where the launches cost more
than the intermediates.  Nothing here waits for the device (index tensors are
copied there once, :func:`device_index`), so the host's launches run ahead
of the device's work.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from ..core.stencil import StencilOperator
from .transfer import coarse_size, prolong_taps, restrict_taps

#: fine grids of at most this many voxels are assembled in one pass over
#: every ``O_0``, not chunked by it
ONE_PASS_VOXELS = 1 << 21


def pair_rows(fine_n: int, centering: str, a: int, off: int):
    """The rows of ``G[J, i] = R[J, i] * P[i + a, J + off]``, the 1-D kernel
    through which fine plane component ``a`` feeds coarse plane component
    ``off`` along one dimension: row J as ``((i, weight), ...)`` in
    ascending i (zero where an index leaves its range).  Built from the
    transfers' tap tables in O(coarse size): the JAX package's dense ``(c,
    f)`` pair matrices cost seconds per pair at 8192 cells."""
    r_start, r_w = restrict_taps(fine_n, centering)
    p_start, p_w = prolong_taps(fine_n, centering)
    c = len(r_start)
    rows = []
    for j in range(c):
        jc = j + off
        row = []
        if 0 <= jc < c:
            for t in range(r_w.shape[1]):
                i, r = int(r_start[j]) + t, float(r_w[j, t])
                t_p = jc - int(p_start[i + a]) if 0 <= i + a < fine_n else -1
                if r != 0.0 and 0 <= t_p < p_w.shape[1] and p_w[i + a, t_p] != 0.0:
                    row.append((i, r * float(p_w[i + a, t_p])))
        rows.append(tuple(row))
    return tuple(rows)


class BandedSpec(NamedTuple):
    """Stride-2 banded form of a pair matrix: Toeplitz interior rows
    ``out[j] = sum_p stencil[p] u[2j+p]`` for ``j in [j0, j1)`` plus explicit
    border rows (possibly with no taps: zero rows) outside the run."""

    c: int
    f: int
    j0: int
    j1: int
    #: ((p, weight), ...) interior taps; () when there is no interior run.
    stencil: Tuple[Tuple[int, float], ...]
    #: ((j, ((i, weight), ...)), ...) rows outside [j0, j1), ascending j.
    rows: Tuple[Tuple[int, Tuple[Tuple[int, float], ...]], ...]


def analyze_banded(rows, f: int) -> BandedSpec | None:
    """The stride-2 banded structure of a pair kernel given by its
    :func:`pair_rows` (None if it is all zero), ``f`` its fine size.

    Rows that match the most common translation-invariant pattern form the
    interior run; every other row is kept as an explicit contraction, so a
    misdetection can only cost speed, never correctness."""
    c = len(rows)
    if not any(rows):
        return None
    pats = [tuple((i - 2 * j, w) for i, w in row) for j, row in enumerate(rows)]
    counts = {}
    for pat in pats:
        if pat:
            counts[pat] = counts.get(pat, 0) + 1
    best = max(counts, key=counts.get)
    j0 = j1 = 0
    if counts[best] >= 2:
        run_start = run_len = best_start = best_len = 0
        for j in range(c + 1):
            if j < c and pats[j] == best:
                if run_len == 0:
                    run_start = j
                run_len += 1
            else:
                if run_len > best_len:
                    best_start, best_len = run_start, run_len
                run_len = 0
        j0, j1 = best_start, best_start + best_len
    stencil = best if j1 > j0 else ()
    border = tuple(
        (j, tuple((2 * j + p, w) for p, w in pats[j]))
        for j in range(c)
        if not (j0 <= j < j1)
    )
    return BandedSpec(c=c, f=f, j0=j0, j1=j1, stencil=stencil, rows=border)


@functools.lru_cache(maxsize=1024)
def banded_pair(fine_n: int, centering: str, a: int, off: int) -> BandedSpec | None:
    """The banded form of one pair kernel (host side, cached by its
    arguments)."""
    return analyze_banded(pair_rows(fine_n, centering, a, off), fine_n)


def _at(ndim: int, axis: int, sl: slice):
    return tuple(sl if i == axis else slice(None) for i in range(ndim))


def _weighted_sum(out: torch.Tensor, terms) -> None:
    """``out = sum_t w_t * x_t`` over ``terms = ((w, x), ...)``, written into
    ``out`` (an empty list of terms writes zeros)."""
    if not terms:
        out.zero_()
        return
    (w, x), rest = terms[0], terms[1:]
    torch.mul(x, w, out=out)
    for w, x in rest:
        out.add_(x * w)


def apply_banded(x: torch.Tensor, spec: BandedSpec, axis: int) -> torch.Tensor:
    """Apply a banded pair kernel along ``axis`` of ``x`` (length ``spec.f``
    there, ``spec.c`` in the output), with strided slices."""
    nd = x.dim()
    shape = list(x.shape)
    shape[axis] = spec.c
    out = x.new_empty(shape)
    for j, taps in spec.rows:
        _weighted_sum(out[_at(nd, axis, slice(j, j + 1))],
                      [(w, x[_at(nd, axis, slice(i, i + 1))]) for i, w in taps])
    if spec.j1 > spec.j0:
        terms = []
        for p, w in spec.stencil:
            lo = 2 * spec.j0 + p
            hi = 2 * (spec.j1 - 1) + p + 1
            terms.append((w, x[_at(nd, axis, slice(lo, hi, 2))]))
        _weighted_sum(out[_at(nd, axis, slice(spec.j0, spec.j1))], terms)
    return out


@functools.lru_cache(maxsize=1024)
def device_index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an index tensor on ``device``, copied there once per
    device: the blocking copy waits for every operation queued before it,
    and the host's launches after it could no longer run ahead of the
    device."""
    return torch.as_tensor(values, device=device)


def _sorted_regroup(cur: torch.Tensor, meta: list, key):
    """Stable-sort the stacked rows by ``key(meta_entry)`` (skipped when
    already grouped)."""
    keys = [key(m) for m in meta]
    order = sorted(range(len(meta)), key=lambda i: keys[i])
    if order == list(range(len(meta))):
        return cur, meta
    return cur[device_index(tuple(order), cur.device)], [meta[i] for i in order]


def _segments(values):
    """(value, start, end) runs of equal consecutive entries."""
    out = []
    start = 0
    for i in range(1, len(values) + 1):
        if i == len(values) or values[i] != values[start]:
            out.append((values[start], start, i))
            start = i
    return out


def _cat(arrays):
    return arrays[0] if len(arrays) == 1 else torch.cat(arrays, 0)


def assemble_galerkin_direct(
    fine_offsets: Tuple[Tuple[int, ...], ...],
    fine_plane: Callable[[int], torch.Tensor],
    centering: Sequence[str],
    coarse_offsets: Tuple[Tuple[int, ...], ...],
    radii: Tuple[int, ...],
) -> StencilOperator:
    """Assemble ``R A P`` directly from the fine coefficient planes.

    ``fine_plane(k)`` returns the plane of ``fine_offsets[k]`` (each is read
    once, into its group's stack).  ``coarse_offsets``/``radii`` define the
    output support (the caller's structural offset table, matching the probe
    path); offsets that receive no contribution come out as zero planes.
    """
    ndim = len(centering)
    first = fine_plane(0)
    fshape = tuple(first.shape)
    dtype, device = first.dtype, first.device
    del first
    cshape = tuple(coarse_size(s, c) for s, c in zip(fshape, centering))

    # per-dimension banded specs for every (fine, coarse) component pair
    specs = []
    for d in range(ndim):
        table = {}
        for a in sorted({off[d] for off in fine_offsets}):
            for o in range(-radii[d], radii[d] + 1):
                table[(a, o)] = banded_pair(fshape[d], centering[d], a, o)
        specs.append(table)

    index = {off: k for k, off in enumerate(coarse_offsets)}
    coeffs = torch.zeros((len(coarse_offsets), *cshape), dtype=dtype, device=device)

    def axis_stage(cur, meta, d):
        """One spatial axis: group rows by their fine offset's component
        ``d`` and apply each valid pair kernel to the whole group."""
        cur, meta = _sorted_regroup(cur, meta, key=lambda m: m[0][d])
        arrays, new_meta = [], []
        for a_val, s, e in _segments([m[0][d] for m in meta]):
            block = cur[s:e]
            for o in range(-radii[d], radii[d] + 1):
                spec = specs[d][(a_val, o)]
                if spec is None:
                    continue
                arrays.append(apply_banded(block, spec, axis=1 + d))
                new_meta += [(a, pfx + (o,)) for a, pfx in meta[s:e]]
        if not arrays:
            return None, []
        return _cat(arrays), new_meta

    def reduce_rows(cur, meta, d_next):
        """Sum factorisation: every later stage depends only on the fine
        offset's remaining components ``a[d_next:]`` and the coarse prefix,
        and is linear, so rows sharing that key are summed now."""
        key = lambda m: (m[0][d_next:], m[1])
        cur, meta = _sorted_regroup(cur, meta, key=key)
        segs = _segments([key(m) for m in meta])
        if len(segs) == len(meta):
            return cur, meta
        arrays, new_meta = [], []
        for _, s, e in segs:
            arrays.append(cur[s:s + 1] if e == s + 1
                          else torch.sum(cur[s:e], dim=0, keepdim=True))
            new_meta.append(meta[s])
        return _cat(arrays), new_meta

    # per-a_0 plane stacks, built once and reused across the O_0 chunks
    group_stacks = {}
    for a_val in sorted({off[0] for off in fine_offsets}):
        idxs = [k for k, off in enumerate(fine_offsets) if off[0] == a_val]
        stack = torch.empty((len(idxs), *fshape), dtype=dtype, device=device)
        for i, k in enumerate(idxs):
            stack[i] = fine_plane(k)
        group_stacks[a_val] = (idxs, stack)

    # chunked by the first axis's coarse component O_0: bounds the stacked
    # intermediates to ~1/(2 r_0 + 1) of the total; a small fine grid takes
    # every O_0 in one pass, since there the launches cost more
    o0s = list(range(-radii[0], radii[0] + 1))
    chunks = [o0s] if math.prod(fshape) <= ONE_PASS_VOXELS else [[o0] for o0 in o0s]
    for chunk in chunks:
        arrays, meta = [], []
        for o0 in chunk:
            for a_val, (idxs, block) in group_stacks.items():
                spec = specs[0][(a_val, o0)]
                if spec is None:
                    continue
                arrays.append(apply_banded(block, spec, axis=1))
                meta += [(fine_offsets[k], (o0,)) for k in idxs]
        if not arrays:
            continue
        cur = _cat(arrays)
        del arrays
        cur, meta = reduce_rows(cur, meta, 1)
        for d in range(1, ndim):
            cur, meta = axis_stage(cur, meta, d)
            if cur is None:
                break
            cur, meta = reduce_rows(cur, meta, d + 1)
        if cur is None:
            continue
        # after the last reduction each row is one full-offset plane
        for _, o_full in meta:
            if o_full not in index:  # the structural table is a superset
                raise AssertionError(
                    f"direct Galerkin produced offset {o_full} outside the "
                    "structural table"
                )
        rows = device_index(tuple(index[o_full] for _, o_full in meta), device)
        coeffs.index_add_(0, rows, cur)
        del cur
    return StencilOperator(coeffs, coarse_offsets)
