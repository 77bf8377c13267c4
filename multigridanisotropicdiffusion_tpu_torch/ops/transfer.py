"""Intergrid transfer: full-weighting restriction and linear prolongation.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.transfer`` with its
``'slice'`` semantics.  The D-dimensional transfers are tensor products of
1-D stencils with per-dimension vertex/cell variants and border rows
(reference itkInterGridOperators.h:101-127), so they are applied one axis at
a time.  1-D stencils (coarse index j, fine index i):

Restriction, vertex (fine n = 2c-1 -> coarse c)
    interior:  out[j] = 1/4 u[2j-1] + 1/2 u[2j] + 1/4 u[2j+1]
    borders:   injection (out[0] = u[0], out[c-1] = u[2c-2])
Restriction, cell (fine n = 2c -> coarse c)
    interior:  out[j] = 1/8 u[2j-1] + 3/8 u[2j] + 3/8 u[2j+1] + 1/8 u[2j+2]
    left:      out[0]   = 1/2 u[0] + 3/8 u[1] + 1/8 u[2]
    right:     out[c-1] = 1/8 u[2c-3] + 3/8 u[2c-2] + 1/2 u[2c-1]
Prolongation, vertex (coarse c -> fine 2c-1)
    fine[2j] = u[j];  fine[2j+1] = (u[j] + u[j+1]) / 2
Prolongation, cell (coarse c -> fine 2c)
    fine[0] = u[0];  fine[2c-1] = u[c-1]
    fine[2j]   = 3/4 u[j] + 1/4 u[j-1]   (j >= 1)
    fine[2j+1] = 3/4 u[j] + 1/4 u[j+1]   (j <= c-2)

:func:`restrict_plain`, :func:`prolong_plain` and :func:`prolong_add_plain`
(``x + P e``) are the plain versions of the transfer kernels
(:mod:`.cuda_transfer`); they act on the trailing
``len(centering)`` axes, so a leading batch axis is allowed.  16-bit storage
computes in float32 and rounds once, like the kernels.  The kernels read the
per-axis tap tables built here (:func:`restrict_taps`, :func:`prolong_taps`)
from the dense 1-D matrices.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.grids import CELL, VERTEX
from ..core.stencil import compute_dtype


def coarse_size(fine: int, centering: str) -> int:
    return fine // 2 if centering == CELL else (fine - 1) // 2 + 1


def fine_size(coarse: int, centering: str) -> int:
    return coarse * 2 if centering == CELL else (coarse - 1) * 2 + 1


# ---------------------------------------------------------------------------
# 1-D transfer matrices and the kernels' tap tables (numpy, host side)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def restrict_matrix_1d(fine_n: int, centering: str) -> np.ndarray:
    """Dense ``(c, f)`` matrix of the 1-D restriction."""
    f = fine_n
    c = coarse_size(f, centering)
    r = np.zeros((c, f))
    if centering == VERTEX:
        r[0, 0] = 1.0
        r[c - 1, f - 1] = 1.0
        for j in range(1, c - 1):
            r[j, 2 * j - 1: 2 * j + 2] = (0.25, 0.5, 0.25)
    else:
        r[0, 0:3] = (0.5, 0.375, 0.125)
        r[c - 1, f - 3: f] = (0.125, 0.375, 0.5)
        for j in range(1, c - 1):
            r[j, 2 * j - 1: 2 * j + 3] = (0.125, 0.375, 0.375, 0.125)
    return r


@functools.lru_cache(maxsize=256)
def prolong_matrix_1d(fine_n: int, centering: str) -> np.ndarray:
    """Dense ``(f, c)`` matrix of the 1-D prolongation."""
    f = fine_n
    c = coarse_size(f, centering)
    p = np.zeros((f, c))
    if centering == VERTEX:
        for j in range(c):
            p[2 * j, j] = 1.0
        for j in range(c - 1):
            p[2 * j + 1, j] = 0.5
            p[2 * j + 1, j + 1] = 0.5
    else:
        p[0, 0] = 1.0
        p[f - 1, c - 1] = 1.0
        for j in range(1, c):
            p[2 * j, j] = 0.75
            p[2 * j, j - 1] = 0.25
        for j in range(c - 1):
            p[2 * j + 1, j] = 0.75
            p[2 * j + 1, j + 1] = 0.25
    return p


def _taps(m: np.ndarray, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise ``(start, weights)`` form of a banded matrix: row ``i`` is
    ``sum_t weights[i, t] * u[start[i] + t]`` (weights past the end of the
    row's support are 0)."""
    start = np.argmax(m != 0, axis=1)
    weights = np.zeros((m.shape[0], width))
    for i, s in enumerate(start):
        seg = m[i, s: s + width]
        weights[i, : seg.size] = seg
        if np.count_nonzero(m[i]) != np.count_nonzero(seg):
            raise AssertionError(f"row {i} wider than {width} taps")
    return start.astype(np.int32), weights


@functools.lru_cache(maxsize=256)
def restrict_taps(fine_n: int, centering: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per coarse index: the first fine index and up to 4 weights."""
    return _taps(restrict_matrix_1d(fine_n, centering), 4)


@functools.lru_cache(maxsize=256)
def prolong_taps(fine_n: int, centering: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per fine index: the first coarse index and up to 2 weights."""
    return _taps(prolong_matrix_1d(fine_n, centering), 2)


# ---------------------------------------------------------------------------
# plain versions (strided slices, one axis at a time)
# ---------------------------------------------------------------------------


def _sl(x: torch.Tensor, axis: int, s: slice) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[axis] = s
    return x[tuple(idx)]


def _restrict_slice_ax(x: torch.Tensor, axis: int, cent: str) -> torch.Tensor:
    n = x.shape[axis]
    if cent == VERTEX:
        c = (n - 1) // 2 + 1
        left = _sl(x, axis, slice(0, 1))
        right = _sl(x, axis, slice(n - 1, n))
        if c <= 2:
            return torch.cat([left, right], dim=axis)
        mid = (
            0.25 * _sl(x, axis, slice(1, n - 3, 2))
            + 0.5 * _sl(x, axis, slice(2, n - 2, 2))
            + 0.25 * _sl(x, axis, slice(3, n - 1, 2))
        )
        return torch.cat([left, mid, right], dim=axis)
    c = n // 2
    left = (
        0.5 * _sl(x, axis, slice(0, 1))
        + 0.375 * _sl(x, axis, slice(1, 2))
        + 0.125 * _sl(x, axis, slice(2, 3))
    )
    right = (
        0.125 * _sl(x, axis, slice(n - 3, n - 2))
        + 0.375 * _sl(x, axis, slice(n - 2, n - 1))
        + 0.5 * _sl(x, axis, slice(n - 1, n))
    )
    if c <= 2:
        return torch.cat([left, right], dim=axis)
    mid = (
        0.125 * _sl(x, axis, slice(1, n - 4, 2))
        + 0.375 * _sl(x, axis, slice(2, n - 3, 2))
        + 0.375 * _sl(x, axis, slice(3, n - 2, 2))
        + 0.125 * _sl(x, axis, slice(4, n - 1, 2))
    )
    return torch.cat([left, mid, right], dim=axis)


def _interleave_ax(even: torch.Tensor, odd: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Merge ``even``/``odd`` along ``axis`` (even first), truncated to n."""
    ne = even.shape[axis]
    if odd.shape[axis] < ne:  # vertex: one fewer odd entry
        pad_shape = list(odd.shape)
        pad_shape[axis] = ne - odd.shape[axis]
        odd = torch.cat([odd, odd.new_zeros(pad_shape)], dim=axis)
    out = torch.stack([even, odd], dim=axis + 1)
    shape = out.shape[:axis] + (2 * ne,) + out.shape[axis + 2:]
    return _sl(out.reshape(shape), axis, slice(0, n))


def _prolong_slice_ax(x: torch.Tensor, axis: int, cent: str) -> torch.Tensor:
    c = x.shape[axis]
    if cent == VERTEX:
        odd = 0.5 * (_sl(x, axis, slice(0, c - 1)) + _sl(x, axis, slice(1, c)))
        return _interleave_ax(x, odd, 2 * c - 1, axis)
    even = torch.cat(
        [
            _sl(x, axis, slice(0, 1)),
            0.75 * _sl(x, axis, slice(1, c)) + 0.25 * _sl(x, axis, slice(0, c - 1)),
        ],
        dim=axis,
    )
    odd = torch.cat(
        [
            0.75 * _sl(x, axis, slice(0, c - 1)) + 0.25 * _sl(x, axis, slice(1, c)),
            _sl(x, axis, slice(c - 1, c)),
        ],
        dim=axis,
    )
    return _interleave_ax(even, odd, 2 * c, axis)


def restrict_plain(x: torch.Tensor, centering: Sequence[str]) -> torch.Tensor:
    """Full-weighting restriction over the trailing ``len(centering)`` axes
    (``centering[d]``: the coarse level's centering in dimension d)."""
    lead = x.dim() - len(centering)
    y = x.to(compute_dtype(x.dtype))
    for d, cent in enumerate(centering):
        y = _restrict_slice_ax(y, lead + d, cent)
    return y.to(x.dtype)


def prolong_plain(x: torch.Tensor, centering: Sequence[str]) -> torch.Tensor:
    """Linear prolongation over the trailing ``len(centering)`` axes."""
    lead = x.dim() - len(centering)
    y = x.to(compute_dtype(x.dtype))
    for d in reversed(range(len(centering))):
        y = _prolong_slice_ax(y, lead + d, centering[d])
    return y.to(x.dtype)


def prolong_add_plain(x: torch.Tensor, e: torch.Tensor,
                      centering: Sequence[str]) -> torch.Tensor:
    """``x + P e`` (the V-cycle's correction): the plain version of the
    prolongation kernel's add form (:func:`.cuda_transfer.cuda_prolong_add`)."""
    return x + prolong_plain(e, centering)


def apply_taps_plain(x: torch.Tensor, tables, order: Sequence[int]) -> torch.Tensor:
    """A transfer given by explicit per-axis tap tables over the trailing
    ``len(tables)`` axes, one axis at a time in ``order``: along axis d,
    ``out[i] = sum_t weights[i, t] * x[start[i] + t]`` (indices clamped into
    the axis; a clamped tap has weight 0).  The plain version of the
    transfer kernels' block form (:func:`.cuda_transfer.restrict_block`,
    :func:`.cuda_transfer.prolong_block`); with the tables of
    :func:`restrict_taps` (axes 0, 1, 2) or :func:`prolong_taps` (axes 2, 1,
    0) it computes :func:`restrict_plain` / :func:`prolong_plain`."""
    lead = x.dim() - len(tables)
    y = x.to(compute_dtype(x.dtype))
    for d in order:
        start, weights = tables[d]
        axis = lead + d
        n = y.shape[axis]
        view = [1] * y.dim()
        view[axis] = len(start)
        out = None
        for t in range(weights.shape[1]):
            idx = torch.as_tensor(np.minimum(np.asarray(start) + t, n - 1), device=y.device)
            w = torch.as_tensor(weights[:, t], dtype=y.dtype, device=y.device).reshape(view)
            term = w * y.index_select(axis, idx)
            out = term if out is None else out + term
        y = out
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def restrict(x: torch.Tensor, centering: Sequence[str],
             use_kernels: bool = False) -> torch.Tensor:
    """Full-weighting restriction of a fine-grid field.  With
    ``use_kernels`` a 3D transfer goes through the transfer kernel's wrapper
    (which takes the plain version for a CPU tensor).  2D transfers run the
    plain version on any device, as the JAX package runs them in XLA (its
    transfer kernels are 3D only).  The dimension is ``len(centering)``: a
    ``(3, Y, X)`` stack of 2D tensor planes has three axes."""
    if use_kernels and len(centering) == 3:
        from .cuda_transfer import cuda_restrict

        return cuda_restrict(x, tuple(centering))
    return restrict_plain(x, centering)


def prolong(x: torch.Tensor, centering: Sequence[str],
            use_kernels: bool = False) -> torch.Tensor:
    """Linear prolongation (interpolation) of a coarse-grid field;
    ``use_kernels`` as in :func:`restrict`."""
    if use_kernels and len(centering) == 3:
        from .cuda_transfer import cuda_prolong

        return cuda_prolong(x, tuple(centering))
    return prolong_plain(x, centering)


def prolong_add(x: torch.Tensor, e: torch.Tensor, centering: Sequence[str],
                use_kernels: bool = False) -> torch.Tensor:
    """``x + prolong(e)`` into a new tensor; with ``use_kernels`` a 3D
    correction is one pass of the prolongation kernel's add form, bit for
    bit ``x + prolong(e, centering, True)``."""
    if use_kernels and len(centering) == 3:
        from .cuda_transfer import cuda_prolong_add

        return cuda_prolong_add(x, e, tuple(centering))
    return prolong_add_plain(x, e, centering)


def restrict_tensor(tensor: torch.Tensor, centering: Sequence[str],
                    use_kernels: bool = False) -> torch.Tensor:
    """Restrict every component of a ``(S, *shape)`` tensor stack (the
    reference restricts each coefficient image, itkGridsHierarchy.hxx:149-188);
    with ``use_kernels`` all components of a 3D stack go in one batched
    launch."""
    return restrict(tensor, centering, use_kernels)
