"""The host tap plan of the stored-operator stencil kernels (B12, B13's
stored form), held bit for bit to ``core.stencil.offdiag_apply`` on the CPU.

Each plan (``ops.cuda_smoothers.tap_plan``) is applied the way the
kernel applies it: x is staged tile by tile as the kernel stages it (a
block's ``TILE_Y`` rows x ``TILE_X`` columns with their halo, zero outside
the grid, each row's column phases apart), and each cell sums, over the
plan's taps in order, its plane's coefficient times the ring value at the
lane's base plus the tap's offset, in the plane of z + dz; each sum starts
at its first product, in the compute dtype.  That is compared with the
plain version by the bytes of the result (signed zeros included), in
float32, bfloat16 and float64, for the 19-, 27-, 117- and 125-plane
layouts, a pruned operator in a non-canonical order and the 2D 9-plane
layout, on shapes that are not whole tiles."""

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch.core.grids import CELL
from multigridanisotropicdiffusion_tpu_torch.core.stencil import (
    StencilOperator,
    compute_dtype,
    offdiag_apply,
    stencil_offsets,
)
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers as cs
from multigridanisotropicdiffusion_tpu_torch.ops import galerkin

DTYPES = [torch.float32, torch.bfloat16, torch.float64]
INTS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    return t.contiguous().view(INTS[t.element_size()])


def _layout(name):
    if name == "19":
        return stencil_offsets(3, 1)
    if name == "27":
        return stencil_offsets(3, 1, drop_corners=False)
    if name == "117":  # level 1 of an exact hierarchy over the 19-point operator
        return galerkin._structural_offsets((CELL,) * 3, stencil_offsets(3, 1), (2, 2, 2))
    if name == "125":
        return stencil_offsets(3, 2, drop_corners=False)
    if name == "pruned":  # 61 planes, every other radius-2 offset dropped, shuffled
        full = stencil_offsets(3, 2, drop_corners=False)
        keep = [o for i, o in enumerate(full) if i % 2 == 0 or max(map(abs, o)) <= 1]
        order = np.random.default_rng(7).permutation(len(keep))
        return tuple(keep[i] for i in order)
    return stencil_offsets(2, 1)  # "2d"


def _operator(offsets, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    coeffs = torch.as_tensor(rng.normal(size=(len(offsets), *shape)))
    coeffs[:, torch.as_tensor(rng.random(shape) < 0.05)] = -0.0  # signed zeros
    x = torch.as_tensor(rng.normal(size=shape) * 10.0)
    x[torch.as_tensor(rng.random(shape) < 0.05)] = 0.0
    return StencilOperator(coeffs.to(dtype), offsets), x.to(dtype)


def _staged_plane(xc, zz, y0, x0, rows, r):
    """One ring plane as the kernel stages it: rows y0 - r .. y0 - r + rows
    - 1; column q of a row (tile column q - VEC) at phase q mod VEC, index q
    // VEC; zero outside the grid; NaN where the kernel stages nothing."""
    nz, ny, nx = xc.shape
    q = torch.arange(cs.ROW)
    gx = x0 + q - cs.VEC
    gy = y0 - r + torch.arange(rows)
    plane = torch.zeros((rows, cs.ROW), dtype=xc.dtype)
    if 0 <= zz < nz:
        inside = ((gy >= 0) & (gy < ny))[:, None] & ((gx >= 0) & (gx < nx))[None, :]
        vals = xc[zz][gy.clamp(0, ny - 1)][:, gx.clamp(0, nx - 1)]
        plane = torch.where(inside, vals, plane)
    staged = (q >= cs.VEC - r) & (q < cs.VEC + cs.TILE_X + r)
    plane[:, ~staged] = float("nan")
    stored = torch.zeros_like(plane)
    stored[:, (q % cs.VEC) * cs.PHASE + q // cs.VEC] = plane
    return stored.reshape(-1)


def _apply_plan(op, x):
    """``offdiag_apply`` as the kernels compute it from the tap plan."""
    plan = cs.tap_plan(op.offsets)
    shape3 = (1,) * (3 - op.ndim) + op.shape
    coeffs = op.coeffs.reshape(len(op.offsets), *shape3)
    cd = compute_dtype(x.dtype)
    xc = x.to(cd).reshape(shape3)
    nz, ny, nx = shape3
    ty_n = cs.TILE_Y[x.dtype]
    r = op.radius
    rows = ty_n + 2 * r
    out = torch.zeros(shape3, dtype=cd)
    ty, lane, j = torch.meshgrid(torch.arange(ty_n), torch.arange(cs.TILE_X // cs.VEC),
                                 torch.arange(cs.VEC), indexing="ij")
    base = (ty + r) * cs.ROW + lane
    for z in range(nz):
        for y0 in range(0, ny, ty_n):
            for x0 in range(0, nx, cs.TILE_X):
                gy, gx = y0 + ty, x0 + cs.VEC * lane + j
                cell = (gy < ny) & (gx < nx)
                gy, gx = gy[cell], gx[cell]
                slots = {}
                acc = None
                for t, dz, _dy, _dx, *offs in plan.tolist():
                    if dz not in slots:
                        slots[dz] = _staged_plane(xc, z + dz, y0, x0, rows, r)
                    idx = (base + torch.as_tensor(offs)[j])[cell]
                    prod = coeffs[t, z, gy, gx].to(cd) * slots[dz][idx]
                    acc = prod if acc is None else acc + prod
                out[z, gy, gx] = acc
    return out.reshape(op.shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout,shape", [
    ("19", (3, 10, 133)), ("27", (3, 9, 131)), ("117", (5, 5, 130)),
    ("125", (5, 9, 37)), ("pruned", (4, 6, 129)), ("2d", (19, 261)),
], ids=["19", "27", "117", "125", "pruned", "2d"])
def test_plan_matches_offdiag_apply_bitwise(layout, shape, dtype):
    op, x = _operator(_layout(layout), shape, dtype, seed=len(shape) + shape[-1])
    want = offdiag_apply(op, x.to(compute_dtype(dtype)))
    got = _apply_plan(op, x)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("layout", ["19", "27", "117", "125", "pruned", "2d"])
def test_plan_lists_the_non_centre_taps_in_order(layout):
    offsets = _layout(layout)
    plan = cs.tap_plan(offsets)
    assert plan.dtype == np.int32 and plan.flags.c_contiguous and not plan.flags.writeable
    assert plan.shape == (len(offsets) - 1, 4 + cs.VEC)
    centre = offsets.index((0,) * len(offsets[0]))
    assert plan[:, 0].tolist() == [t for t in range(len(offsets)) if t != centre]
    for (t, dz, dy, dx, *_), off in zip(plan.tolist(), [o for o in offsets if any(o)]):
        assert (dz, dy, dx) == (0,) * (3 - len(off)) + tuple(off)
        assert offsets[t] == off
    assert cs.tap_plan(offsets) is plan  # cached per table
    # the compiled tap counts of the solves' layouts
    counts = {"19": 18, "27": 26, "117": 116, "125": 124, "2d": 8}
    if layout in counts:
        assert len(plan) == counts[layout]


def test_check_grid_refuses_taller_fields():
    cs.check_grid("t", (1, 65535 * 8, 4), torch.float32)
    cs.check_grid("t", (65535 * 4, 4), torch.float64)
    for shape, dtype in (((1, 65535 * 8 + 1, 4), torch.bfloat16),
                         ((65535 * 4 + 1, 4), torch.float64)):
        with pytest.raises(ValueError):
            cs.check_grid("t", shape, dtype)
