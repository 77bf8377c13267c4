"""The Galerkin product kernel (B16): one coarse level's stored operator
``A_c = I - map(R (I - A_f) P)`` straight from the fine operator's planes,
in one pass (``csrc/galerkin_product.cu``).

The JAX package leaves this product to XLA (``ops.galerkin_direct``, comb
probing in ``ops.galerkin``); no Pallas kernel is replaced.  The kernel reads
the fine operator's planes as they are stored, a 3D compressed operator's 10
or a stored level's K, and writes nothing but the coarse planes: the spatial
part ``S = I - A_f``, the products with the transfers, the collapse onto
radius 1 (``galerkin_variant='collapsed'``) or the exact offset table, and
the identity added back are all inside it.

The product is a sum of separable 1-D contractions (``ops.galerkin_direct``):

    S_c[J, O] = sum_a sum_i prod_d G_d^{a_d, O_d}[J_d, i_d] * s_a[i]

with ``G_d^{a, O}[J, i] = R_d[J, i] P_d[i + a, J + O]`` (``pair_rows``),
``s_a = -c_a`` off the centre and ``1 - c_0`` on it.  The host plan
(:func:`product_plan`, built once per shape, centring, fine offset table and
variant) holds, per axis, the pair kernels as tables over a coarse index's
four restriction taps: ``weights[J, t, a, o]`` is ``G^{a, o}[J, starts[J] +
t]``.  The collapse is component-wise clipping of ``O``, so it folds into
the tables: the collapsed variant's ``o`` in ``[-1, 1]`` sums the pair
kernels of every ``O`` that clips onto it.  The exact variant's ``o`` is
``O`` itself.  The fine planes enter through a table over the fine offsets'
components, ``fine[a_z, a_y, a_x]``: each offset's plane, the sign that
turns it into ``s_a`` and whether it is the centre; the output map
``out_map[o_z, o_y, o_x]`` names each output plane, in the eager path's
order.

:func:`galerkin_product_plain` applies a plan with dense per-axis matrices
(its plain version, for a CPU tensor).  :func:`cuda_galerkin_product` takes
the plain version for a CPU tensor; for a CUDA tensor it launches the kernel
(float32 or float64) or raises.  ``cuda_galerkin_product.launches``, a
``collections.Counter``, counts launches by variant: ``"collapsed"`` or
``"exact"``; ``cuda_galerkin_product.forms`` counts them by the form the
launch took (:data:`FORMS`).

**Forms.**  The plan names the form its tables take (``ProductPlan.form``),
and the kernel's entry point checks that the tables are that form's before
it launches the form's compiled code.  The collapsed chain's two fine
operators, on cell-centred y and x axes, with the clipped interior rows
(:func:`cell_weight`): ``compressed19`` and ``stored27``.  The exact chain's
three, on cell-centred axes, with the unclipped interior rows
(:func:`exact_weight`) and every row of each axis table inside its window
``2 J - 1 .. 2 J + 2`` and within the interior row's non-zero entries
(:func:`window_table`): ``exact19`` (the compressed operator -> 117 planes),
``exact117`` (117 stored planes -> 125) and ``exact125`` (125 -> 125).  Any
other table is ``generic``: the tables are read at run time.
"""

from __future__ import annotations

import collections
import functools
import itertools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.grids import CELL
from ..core.stencil import StencilOperator, stencil_offsets
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .compressed import CompressedDCAOperator
from .galerkin import _structural_offsets, galerkin_offsets, plane_table
from .transfer import coarse_size, prolong_taps, restrict_taps

#: the storage types the kernel is built for
KERNEL_DTYPES = (torch.float32, torch.float64)
#: the kernel's forms, by their code in ``csrc/galerkin_product.cu``
FORMS = ("generic", "compressed19", "stored27", "exact19", "exact117", "exact125")

#: the kernel's tile (``csrc/galerkin_product.cu``): a block owns
#: ``TILE_X`` coarse x by ``TILE_Y`` coarse y and marches in z; it stages
#: ``ROWS`` fine rows of ``COLS`` fine x, the window's first column rounded
#: down to a multiple of ``ALIGN`` (16-byte copies)
TILE_X, TILE_Y, ROWS, COLS, ALIGN = 32, 7, 16, 72, 4
#: restriction taps per coarse index
TAPS = 4
#: a launch takes about this many blocks (some fifteen waves of two blocks
#: per SM on an H100: short chunks balance the SMs' loads), its z chunks at
#: least ``MIN_ZCHUNK`` coarse planes long (each chunk re-reads 1-2 fine
#: planes at its start), or an eighth of a small level's
BLOCKS, MIN_ZCHUNK = 4096, 8
#: the exact forms' tile: ``TILE_X`` coarse x by ``EXACT_TILE_Y`` coarse y,
#: the fine rows ``2 y0 - 1 .. 2 y0 + 2 EXACT_TILE_Y`` staged
EXACT_TILE_Y = 2


class ProductPlan(NamedTuple):
    """The kernel's host plan of one level (see the module docstring)."""

    fine_shape: Tuple[int, int, int]
    coarse_shape: Tuple[int, int, int]
    #: fine offset components per axis (2 * fine radius + 1)
    A: int
    #: output components per axis (3 collapsed, 2 * coarse radius + 1 exact)
    O: int
    #: output offsets, in the output planes' order
    offsets: Tuple[Tuple[int, int, int], ...]
    #: (A, A, A) int32: ``plane * 4 + 2 * negate + centre``, -1 where the
    #: fine operator has no such offset
    fine: np.ndarray
    #: (O, O, O) int32: output plane, -1 where none
    out_map: np.ndarray
    #: int32 ``[starts_z, starts_y, starts_x, lens_z]``: each coarse index's
    #: first restriction tap and, along z, its window's length
    starts: np.ndarray
    #: float32 ``(cz + cy + cx, TAPS, A, O)``: the pair kernels per axis
    #: (dyadic rationals, exact in float32)
    weights: np.ndarray
    #: float32 ``(3, TAPS, A, O)``: the y, x and z tables' interior row, the
    #: one their rows ``runs[0]:runs[1]`` (y), ``runs[2]:runs[3]`` (x) and
    #: ``runs[4]:runs[5]`` (z) hold, each starting at ``2 J - 1``
    interior: np.ndarray
    runs: np.ndarray
    #: coarse z planes per block
    zchunk: int
    #: the kernel's form for these tables (:data:`FORMS`)
    form: str


def _frozen(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    a.flags.writeable = False  # shared by every caller of the cache
    return a


@functools.lru_cache(maxsize=256)
def axis_table(fine_n: int, centering: str, fine_radius: int, coarse_radius: int,
               ra: int, ro: int, collapse: bool):
    """One axis's ``(starts, lens, weights)``: per coarse index ``J`` the
    first restriction tap ``starts[J]``, the length of its window up to the
    last non-zero tap, and ``weights[J, t, a + ra, o + ro] = R[J, i] * P[i +
    a, J + O]`` at ``i = starts[J] + t``, summed over the ``O`` that clip
    onto ``o`` under ``collapse``, for ``|a| <= fine_radius``."""
    r_start, r_w = restrict_taps(fine_n, centering)
    p_start, p_w = prolong_taps(fine_n, centering)
    c = len(r_start)
    w = np.zeros((c, TAPS, 2 * ra + 1, 2 * ro + 1))
    for j, t, a, k in itertools.product(range(c), range(TAPS),
                                        range(-fine_radius, fine_radius + 1), range(2)):
        i = int(r_start[j]) + t
        f = i + a
        if r_w[j, t] == 0.0 or not 0 <= f < fine_n or p_w[f, k] == 0.0:
            continue
        off = int(p_start[f]) + k - j
        if abs(off) > coarse_radius:
            raise AssertionError(f"pair kernel reaches offset {off} past radius {coarse_radius}")
        o = max(-1, min(1, off)) if collapse else off
        w[j, t, a + ra, o + ro] += r_w[j, t] * p_w[f, k]
    nz_taps = np.nonzero(w.reshape(c, TAPS, -1).any(axis=2))
    lens = np.ones(c, dtype=np.int32)
    for j, t in zip(*nz_taps):
        lens[j] = max(lens[j], t + 1)
    return (_frozen(r_start.astype(np.int32)), _frozen(lens),
            _frozen(w.astype(np.float32)))


def cell_weight(t: int, a: int, o: int) -> float:
    """The collapsed chain's interior row on a cell-centred axis (the
    kernel's ``cell_weight``): tap ``t`` (fine ``2 J - 1 + t``), fine offset
    component ``a - 1``, output ``o - 1``: the restriction's ``1 3 3 1 / 8``
    times the prolongation's 3/4 and 1/4 of fine row ``2 J - 2 + t + a`` onto
    coarse ``J + o``, clipped to ``[-1, 1]``."""
    f = t - 2 + a
    m = f // 2
    k1 = m - 1 if f % 2 == 0 else m + 1
    w = (0.75 if max(-1, min(1, m)) == o - 1 else 0.0) + (
        0.25 if max(-1, min(1, k1)) == o - 1 else 0.0)
    return (0.125, 0.375, 0.375, 0.125)[t] * w


def exact_weight(t: int, a: int, o: int, ra: int) -> float:
    """The exact chain's interior row on a cell-centred axis (the kernel's
    ``exact_weight``): tap ``t``, fine offset component ``a - ra``, output
    ``o - 2``, unclipped."""
    f = t - 1 + a - ra
    m = f // 2
    k1 = m - 1 if f % 2 == 0 else m + 1
    w = (0.75 if m == o - 2 else 0.0) + (0.25 if k1 == o - 2 else 0.0)
    return (0.125, 0.375, 0.375, 0.125)[t] * w


@functools.lru_cache(maxsize=None)
def interior_row(A: int, O: int) -> np.ndarray:
    """float32 ``(TAPS, A, O)``: the compiled-in interior row of the forms
    with ``A`` fine and ``O`` output components (collapsed: 3 x 3, exact:
    3 or 5 x 5); read-only."""
    if O == 3:
        row = [[[cell_weight(t, a, o) for o in range(3)] for a in range(3)]
               for t in range(TAPS)]
    else:
        row = [[[exact_weight(t, a, o, A // 2) for o in range(O)] for a in range(A)]
               for t in range(TAPS)]
    return _frozen(np.array(row, dtype=np.float32))


def window_table(starts: np.ndarray, weights: np.ndarray):
    """One axis table re-indexed to its rows' windows ``2 J - 1 .. 2 J + 2``
    (the exact forms' march): ``w[J, t]`` at tap ``starts[J] + t - (2 J -
    1)``; None where a non-zero weight falls outside its window or outside
    the interior row's non-zero entries."""
    c = len(starts)
    pattern = interior_row(weights.shape[2], weights.shape[3]) != 0
    out = np.zeros_like(weights)
    shift = starts.astype(np.int64) - (2 * np.arange(c) - 1)
    for t in range(TAPS):
        tt = t + shift
        live = weights[:, t].reshape(c, -1).any(axis=1)
        if ((tt < 0) | (tt >= TAPS))[live].any():
            return None
        j = np.nonzero(live)[0]
        out[j, tt[j]] = weights[j, t]
    if (out != 0)[:, ~pattern].any():
        return None
    return out


def _fine_table(fine_offsets, terms, ra: int) -> np.ndarray:
    """``(A, A, A)`` int32: ``plane * 4 + 2 * negate + centre`` per fine
    offset, -1 where none."""
    A = 2 * ra + 1
    fine = np.full((A, A, A), -1, dtype=np.int32)
    for off, (p, sign) in zip(fine_offsets, terms):
        centre = all(o == 0 for o in off)
        fine[tuple(o + ra for o in off)] = 4 * p + (2 if sign > 0 else 0) + int(centre)
    return fine


def _out_map(offsets, ro: int) -> np.ndarray:
    """``(O, O, O)`` int32: output plane per offset, -1 where none."""
    O = 2 * ro + 1
    out_map = np.full((O, O, O), -1, dtype=np.int32)
    for k, off in enumerate(offsets):
        out_map[tuple(o + ro for o in off)] = k
    return out_map


@functools.lru_cache(maxsize=None)
def form_tables():
    """Per compiled-in form, its ``(fine, out_map)`` tables as a plan holds
    them: the collapsed chain's fine operators (the compressed 19-point
    operator's planes with their signs, 27 stored planes) onto 27 outputs,
    and the exact chain's (that compressed operator onto the 5^3 box less
    its corners, 117 planes; 117 and 125 stored planes onto 125)."""
    c19 = plane_table(CompressedDCAOperator(torch.zeros((10, 1, 1, 1)), 3))
    s27 = stencil_offsets(3, 1, drop_corners=False)
    s117 = _structural_offsets((CELL,) * 3, stencil_offsets(3), (2, 2, 2))
    s125 = stencil_offsets(3, 2, drop_corners=False)

    def stored(offsets):
        return offsets, tuple((k, 1.0) for k in range(len(offsets)))

    tables = {}
    for form, (offsets, terms), ra, outs in (
            ("compressed19", (c19[0], c19[2]), 1, s27), ("stored27", stored(s27), 1, s27),
            ("exact19", (c19[0], c19[2]), 1, s117), ("exact117", stored(s117), 2, s125),
            ("exact125", stored(s125), 2, s125)):
        tables[form] = (_frozen(_fine_table(offsets, terms, ra)),
                        _frozen(_out_map(outs, max(abs(o) for off in outs for o in off))))
    return tables


def _form(centering, fine, out_map, interior, runs, windows) -> str:
    """The form the kernel takes for these tables (the entry point checks
    them against the form's compiled tables)."""
    A, O = fine.shape[0], out_map.shape[0]
    for form, (f, m) in form_tables().items():
        if f.shape != fine.shape or m.shape != out_map.shape or not (
                np.array_equal(f, fine) and np.array_equal(m, out_map)):
            continue
        row = interior_row(A, O)
        if form.startswith("exact"):
            # every axis cell-centred, its rows in their windows, and the
            # interior rows on their (non-empty) runs the compiled one
            if (all(c == CELL for c in centering) and all(w is not None for w in windows)
                    and all(runs[2 * k] >= runs[2 * k + 1]
                            or np.array_equal(interior[k], row) for k in range(3))):
                return form
        elif np.array_equal(interior[0], row) and np.array_equal(interior[1], row):
            return form
    return "generic"


def interior_run(starts: np.ndarray, weights: np.ndarray):
    """``(row, lo, hi)``: the longest run ``lo:hi`` of an axis table's rows
    that start at ``2 J - 1`` and hold one row, and that row (zeros and an
    empty run where no two rows agree)."""
    c = len(starts)
    best = (np.zeros(weights.shape[1:], dtype=weights.dtype), 0, 0)
    j = 0
    while j < c:
        k = j
        while (k < c and starts[k] == 2 * k - 1 and starts[j] == 2 * j - 1
               and np.array_equal(weights[k], weights[j])):
            k += 1
        if k - j >= 2 and k - j > best[2] - best[1]:
            best = (weights[j], j, k)
        j = max(k, j + 1)
    return best


def _check_geometry(zs, zl, ys, yl, xs) -> None:
    """The kernel's march and tile hold: along z each fine plane feeds at
    most two coarse planes, the windows in order and without a gap; a
    tile's y rows (up to each row's last non-zero tap) and x columns fit its
    staged window."""
    end = zs + zl - 1
    if not (np.all(np.diff(end) > 0) and np.all(zs[1:] <= end[:-1] + 1)
            and np.all(zs[2:] > end[:-2])):
        raise AssertionError("z windows do not march two at a time")
    for j0 in range(0, len(ys), TILE_Y):
        if max(ys[j0:j0 + TILE_Y] + yl[j0:j0 + TILE_Y]) - ys[j0] > ROWS:
            raise AssertionError(f"y tile at {j0} needs more than {ROWS} rows")
    for j0 in range(0, len(xs), TILE_X):
        # a lane reads its taps as three pairs from the even column at or
        # before its first
        if ((xs[min(j0 + TILE_X, len(xs)) - 1] - (xs[j0] & ~(ALIGN - 1))) & ~1) + 6 > COLS:
            raise AssertionError(f"x tile at {j0} needs more than {COLS} columns")


@functools.lru_cache(maxsize=64)
def product_plan(fine_shape: Tuple[int, int, int], centering: Tuple[str, ...],
                 fine_offsets, terms, collapse: bool) -> ProductPlan:
    """The kernel's plan for a fine operator of ``fine_shape`` with
    ``fine_offsets`` and their ``(plane, sign)`` terms
    (:func:`.galerkin.plane_table`), cached by its arguments."""
    ndim = len(fine_shape)
    if ndim != 3 or len(centering) != 3:
        raise ValueError(f"the Galerkin product kernel is 3D, got shape {fine_shape}")
    fine_radii = tuple(max(abs(off[d]) for off in fine_offsets) for d in range(3))
    _, radii = galerkin_offsets(centering, fine_radii)
    structural = _structural_offsets(centering, fine_offsets, radii)
    ra = max(fine_radii)
    ro = 1 if collapse else max(radii)
    if ra > 2 or ro > 2:
        raise ValueError(f"the Galerkin product kernel takes radius <= 2, got {fine_radii}")
    if collapse:
        targets = {tuple(max(-1, min(1, o)) for o in off) for off in structural}
        offsets = tuple(off for off in stencil_offsets(3, 1, drop_corners=False)
                        if off in targets)
    else:
        offsets = structural
    tables = [axis_table(n, c, rf, rc, ra, ro, collapse)
              for n, c, rf, rc in zip(fine_shape, centering, fine_radii, radii)]
    (zs, zl, wz), (ys, yl, wy), (xs, _, wx) = tables
    _check_geometry(zs, zl, ys, yl, xs)
    A, O = 2 * ra + 1, 2 * ro + 1
    fine = _fine_table(fine_offsets, terms, ra)
    out_map = _out_map(offsets, ro)
    # every output that can receive a contribution has a plane (as the
    # direct path checks against the structural table)
    reach = [w.any(axis=(0, 1)) for w in (wz, wy, wx)]  # (A, O) per axis
    for o in itertools.product(range(O), repeat=3):
        if out_map[o] < 0 and any(
                all(reach[d][a[d] + ra, o[d]] for d in range(3)) for a in fine_offsets):
            raise AssertionError(f"the product reaches offset {o} outside the table")
    cshape = tuple(coarse_size(n, c) for n, c in zip(fine_shape, centering))
    (iy, ylo, yhi), (ix, xlo, xhi), (iz, zlo, zhi) = (
        interior_run(ys, wy), interior_run(xs, wx), interior_run(zs, wz))
    interior = np.stack([iy, ix, iz])
    runs = np.array([ylo, yhi, xlo, xhi, zlo, zhi], dtype=np.int32)
    windows = ([window_table(st, w) for st, w in ((ys, wy), (xs, wx), (zs, wz))]
               if O == 5 else [None] * 3)
    form = _form(tuple(centering), fine, out_map, interior, runs, windows)
    if form.startswith("exact"):
        tiles = -(-cshape[2] // TILE_X) * -(-cshape[1] // EXACT_TILE_Y)
    else:
        # the generic exact variant's five output z components take a pass each
        tiles = -(-cshape[2] // TILE_X) * -(-cshape[1] // TILE_Y) * (1 if O == 3 else O)
    zchunk = max(min(MIN_ZCHUNK, max(2, cshape[0] // 8)), -(-cshape[0] // -(-BLOCKS // tiles)))
    return ProductPlan(
        fine_shape=tuple(fine_shape), coarse_shape=cshape, A=A, O=O, offsets=offsets,
        fine=_frozen(fine), out_map=_frozen(out_map),
        starts=_frozen(np.concatenate([zs, ys, xs, zl]).astype(np.int32)),
        weights=_frozen(np.concatenate([wz, wy, wx])),
        interior=_frozen(interior), runs=_frozen(runs),
        zchunk=min(zchunk, cshape[0]), form=form)


def kernel_weights(plan: ProductPlan) -> np.ndarray:
    """The axis weights as the kernel reads them, flat: the z and y tables
    as they are, the x table transposed to ``(TAPS * A * O, cx)``, so that a
    warp's lanes (consecutive coarse x) read consecutive values; each
    re-indexed to its rows' windows (:func:`window_table`) for the exact
    forms.  (Interior rows come from the kernel's parameters or its
    compiled-in forms; a border row's weights are read from here, so that a
    coupling that leaves the grid sums exact zeros.)"""
    cz, cy, cx = plan.coarse_shape
    w = plan.weights
    if plan.form.startswith("exact"):
        s = plan.starts
        w = np.concatenate([window_table(s[lo:hi], w[lo:hi])
                            for lo, hi in ((0, cz), (cz, cz + cy), (cz + cy, cz + cy + cx))])
    wx = w[cz + cy:].reshape(cx, -1).T
    return np.concatenate([w[:cz + cy].reshape(-1), wx.reshape(-1)])


def _dense(fine_n: int, starts: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """``(A, O, c, fine_n)``: one axis's tables as dense pair matrices."""
    c = len(starts)
    m = np.zeros((weights.shape[2], weights.shape[3], c, fine_n))
    for t in range(TAPS):
        i = starts + t
        ok = i < fine_n
        m[:, :, np.arange(c)[ok], i[ok]] += np.moveaxis(weights[ok, t], 0, -1)
    return m


def galerkin_product_plain(plan: ProductPlan, planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the ``(len(plan.offsets), *coarse)``
    planes of ``A_c`` from the fine ``(P, Z, Y, X)`` planes, each fine
    offset's ``s_a`` contracted axis by axis with the plan's pair matrices."""
    nz, ny, nx = plan.fine_shape
    cz, cy, cx = plan.coarse_shape
    ra, ro = plan.A // 2, plan.O // 2
    s = plan.starts
    mats = [torch.as_tensor(_dense(n, st, w), dtype=planes.dtype, device=planes.device)
            for n, st, w in ((nz, s[:cz], plan.weights[:cz]),
                             (ny, s[cz:cz + cy], plan.weights[cz:cz + cy]),
                             (nx, s[cz + cy:cz + cy + cx], plan.weights[cz + cy:]))]
    mz, my, mx = mats
    acc = planes.new_zeros((plan.O,) * 3 + (cz, cy, cx))
    for a in itertools.product(range(plan.A), repeat=3):
        code = int(plan.fine[a])
        if code < 0:
            continue
        v = planes[code >> 2]
        sa = -v if code & 2 else v
        if code & 1:
            sa = 1.0 + sa
        tx = torch.einsum("zyi,oji->ozyj", sa, mx[a[2]])
        ty = torch.einsum("ozyj,pky->pozkj", tx, my[a[1]])
        acc += torch.einsum("pozkj,qlz->qpolkj", ty, mz[a[0]])
    out = []
    for off in plan.offsets:
        plane = -acc[tuple(o + ro for o in off)]
        out.append(1.0 + plane if off == (0, 0, 0) else plane)
    return torch.stack(out)


def kernel_takes(op) -> bool:
    """Whether B16 takes ``op``: a 3D stored or compressed operator on the
    card in float32 or float64 (a matrix-free one has no planes)."""
    if isinstance(op, StencilOperator):
        planes = op.coeffs
    elif isinstance(op, CompressedDCAOperator):
        planes = op.planes
    else:
        return False
    return planes.dim() == 4 and planes.is_cuda and planes.dtype in KERNEL_DTYPES


@functools.lru_cache(maxsize=64)
def device_tables(fine_shape, centering, fine_offsets, terms, collapse: bool,
                  device: torch.device):
    """The plan's axis tables on ``device``, copied there once per plan and
    device: the blocking copy waits for the work queued before it."""
    plan = product_plan(fine_shape, centering, fine_offsets, terms, collapse)
    return (torch.tensor(plan.starts, device=device),
            torch.tensor(kernel_weights(plan), device=device))


def cuda_galerkin_product(fine_op, centering: Sequence[str],
                          collapse: bool) -> StencilOperator:
    """``I - R (I - A_f) P`` of a 3D stored or compressed ``fine_op``,
    collapsed onto radius 1 under ``collapse``, as a stored operator
    (semantics of :func:`.galerkin.assemble_galerkin_parabolic`)."""
    name = "cuda_galerkin_product"
    fine_offsets, planes, terms = plane_table(fine_op)
    if planes.dim() != 4 or len(centering) != 3:
        raise ValueError(f"{name}: needs a 3D operator, got planes {tuple(planes.shape)}")
    key = (tuple(planes.shape[1:]), tuple(centering), fine_offsets, terms, bool(collapse))
    plan = product_plan(*key)
    if planes.device.type == "cpu":
        return StencilOperator(galerkin_product_plain(plan, planes), plan.offsets)
    require_cuda(name, planes)
    if planes.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: no kernel for dtype {planes.dtype}")
    starts, weights = device_tables(*key, planes.device)
    out = torch.empty((len(plan.offsets), *plan.coarse_shape), dtype=planes.dtype,
                      device=planes.device)
    err = kernel("mad_galerkin_product", planes.dtype)(
        planes.data_ptr(), out.data_ptr(), planes.shape[0], *plan.fine_shape,
        *plan.coarse_shape, plan.fine.ctypes.data, plan.A, plan.out_map.ctypes.data,
        plan.O, len(plan.offsets), starts.data_ptr(), weights.data_ptr(),
        plan.interior.ctypes.data, plan.runs.ctypes.data, plan.zchunk,
        FORMS.index(plan.form), stream_of(planes))
    check_launch(err, name)
    cuda_galerkin_product.launches["collapsed" if collapse else "exact"] += 1
    cuda_galerkin_product.forms[plan.form] += 1
    return StencilOperator(out, plan.offsets)


cuda_galerkin_product.launches = collections.Counter()
cuda_galerkin_product.forms = collections.Counter()
