"""The Galerkin product kernel's (B16) host plan, checked on the CPU: its
per-axis tables hold the pair kernels (``ops.galerkin_direct.pair_rows``,
folded by clipping for the collapsed variant), its output map the eager
path's offsets (``_structural_offsets``, ``collapse_to_radius1``), its fine
table ``plane_getter``'s planes and signs.  The plan applied
(``galerkin_product_plain``) and an emulation of the kernel's march (its
blocks, staged tiles, stages and z windows, step for step as
``csrc/galerkin_product.cu`` runs them) are held to the eager path in
float64: 1e-12 of the largest diagonal value, a summation-order difference;
for the exact chain's three compiled-in forms the emulation follows their
own march (``galerkin_product_kernel_exact``).  The form each plan names
(``ProductPlan.form``) is checked on whole hierarchies, and the compiled-in
interior rows against each level's rows from ``pair_rows``.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch.core.grids import (
    CELL,
    VERTEX,
    build_level_descriptors,
)
from multigridanisotropicdiffusion_tpu_torch.core.stencil import StencilOperator, stencil_offsets
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.ops import compressed, dca, galerkin
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_galerkin as cg
from multigridanisotropicdiffusion_tpu_torch.ops.galerkin_direct import pair_rows
from multigridanisotropicdiffusion_tpu_torch.ops.matfree import MatrixFreeDCAOperator

from .conftest import make_spd_tensor_field

DT = 0.1


def _centering(shape):
    """The hierarchy's rule: even sizes cell-centred, odd vertex-centred."""
    return tuple(CELL if n % 2 == 0 else VERTEX for n in shape)


def _fine_op(shape, form, seed=0):
    if form == "random125":
        # random planes on the 5^3 box (an exact level's layout), non-zero on
        # every border, a dominant diagonal
        offsets = stencil_offsets(3, 2, drop_corners=False)
        coeffs = torch.as_tensor(np.random.default_rng(seed).normal(
            0.0, 0.05, (len(offsets), *shape)))
        coeffs[offsets.index((0, 0, 0))] = coeffs.abs().sum(0) + 1.0
        return StencilOperator(coeffs, offsets)
    mat = make_spd_tensor_field(np.random.default_rng(seed), shape, 3, hi=3.0)
    t = as_sym_planes(mat, shape)
    if form == "compressed":
        return compressed.assemble_compressed_dca(t, (1.0, 0.9, 1.1), DT)
    return dca.assemble_dca(t, (1.0, 0.9, 1.1), DT)


def _plan(op, centering, collapse):
    offsets, planes, terms = galerkin.plane_table(op)
    return cg.product_plan(tuple(planes.shape[1:]), tuple(centering), offsets, terms,
                           collapse)


def _rel_err(got, want):
    assert got.offsets == want.offsets
    return ((got.coeffs - want.coeffs).abs().max() / want.diag.abs().max()).item()


@pytest.mark.parametrize("fine_n,centering", [(8, CELL), (16, CELL), (4, CELL), (9, VERTEX),
                                              (17, VERTEX), (5, VERTEX), (3, VERTEX)])
@pytest.mark.parametrize("fine_radius", [1, 2])
@pytest.mark.parametrize("collapse", [False, True], ids=["exact", "collapsed"])
def test_axis_tables_reproduce_pair_rows(fine_n, centering, fine_radius, collapse):
    """Every pair_rows row at its coarse index's restriction taps, folded
    by clipping under ``collapse``, and nothing else; windows start at the
    restriction's first tap and end at the last non-zero one."""
    rc = (3 + fine_radius) // 2 if centering == CELL else (2 + fine_radius) // 2
    ra, ro = 2, 1 if collapse else 2
    starts, lens, w = cg.axis_table(fine_n, centering, fine_radius, rc, ra, ro, collapse)
    c = len(starts)
    want = np.zeros_like(w, dtype=np.float64)
    for a in range(-fine_radius, fine_radius + 1):
        for off in range(-rc, rc + 1):
            o = max(-1, min(1, off)) if collapse else off
            for j, row in enumerate(pair_rows(fine_n, centering, a, off)):
                for i, weight in row:
                    assert 0 <= i - starts[j] < cg.TAPS
                    want[j, i - starts[j], a + ra, o + ro] += weight
    np.testing.assert_array_equal(w.astype(np.float64), want)
    assert w.dtype == np.float32
    for j in range(c):
        nz_t = np.nonzero(w[j].reshape(cg.TAPS, -1).any(axis=1))[0]
        assert lens[j] == max(1, nz_t.max() + 1 if len(nz_t) else 1)


@pytest.mark.parametrize("shape,form", [
    (shape, form) for shape in [(16, 16, 16), (17, 17, 17), (12, 10, 9), (4, 9, 8)]
    for form in ("compressed", "stored", "exact_level")
    if not (form == "exact_level" and min(shape) < 6)], ids=str)
def test_output_map_and_fine_table_reproduce_the_eager_path(shape, form):
    """The output offsets: ``_structural_offsets`` (exact) and
    ``collapse_to_radius1``'s (collapsed), in their order, each once in the
    map; the fine table: ``plane_getter``'s spatial part ``s_a`` from each
    offset's plane, sign and centre."""
    op = _fine_op(shape, "compressed" if form == "compressed" else "stored")
    if form == "exact_level":
        op = galerkin.assemble_galerkin_parabolic(op, _centering(shape))
        shape = op.shape
    cent = _centering(shape)
    offsets, planes, _ = galerkin.plane_table(op)
    radii = galerkin.galerkin_offsets(cent, galerkin._per_dim_radii(offsets))[1]
    structural = galerkin._structural_offsets(cent, offsets, radii)
    _, get = galerkin.plane_getter(galerkin._SpatialPart(op))
    for collapse in (False, True):
        plan = _plan(op, cent, collapse)
        zero = torch.zeros((len(structural), 1, 1, 1), dtype=torch.float64)
        want = (galerkin.collapse_to_radius1(StencilOperator(zero, structural)).offsets
                if collapse else structural)
        assert plan.offsets == want
        ro = plan.O // 2
        mapped = {int(plan.out_map[tuple(o + ro for o in off)]) for off in plan.offsets}
        assert mapped == set(range(len(want)))
        assert (plan.out_map >= 0).sum() == len(want)
        ra = plan.A // 2
        assert (plan.fine >= 0).sum() == len(offsets)
        for k, off in enumerate(offsets):
            code = int(plan.fine[tuple(o + ra for o in off)])
            v = planes[code >> 2]
            s = -v if code & 2 else v
            s = 1.0 + s if code & 1 else s
            assert torch.equal(s, get(k)), off


SHAPES = [(16, 16, 16), (17, 17, 17), (12, 10, 9), (4, 9, 8), (8, 40, 70), (9, 18, 66)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("form", ["compressed", "stored"])
@pytest.mark.parametrize("collapse", [True, False], ids=["collapsed", "exact"])
def test_plain_product_matches_the_eager_path(shape, form, collapse):
    """The plan applied, on two levels (a stored level feeds the second),
    against ``assemble_galerkin_parabolic``'s eager path."""
    op = _fine_op(shape, form)
    for _ in range(2):
        cent = _centering(op.shape)
        want = galerkin.assemble_galerkin_parabolic(op, cent, collapse=collapse)
        got = cg.cuda_galerkin_product(op, cent, collapse)
        assert _rel_err(got, want) <= 1e-12
        if min(want.shape) < 3:
            break
        op = want


def _params(plan, n_planes, plane_elems):
    """The fine table by (a_z, a_y) group, as the kernel stages it: the
    group's distinct planes (slots, as element offsets), per a_x its slot
    and bits; the groups with planes in order, and which is its a_z's
    last.  (``csrc/galerkin_product.cu`` packs an a_z's groups into steps
    of shared slots; the arithmetic per group is the same.)"""
    A = plan.A
    slot_plane, ax_slot, ax_bits, nslot, order = {}, {}, {}, {}, []
    for g in range(A * A):
        slots = []
        for ax in range(A):
            code = int(plan.fine.reshape(-1)[g * A + ax])
            ax_slot[g, ax], ax_bits[g, ax] = -1, 0
            if code < 0:
                continue
            assert code >> 2 < n_planes
            off = (code >> 2) * plane_elems
            if off not in slots:
                slots.append(off)
            ax_slot[g, ax], ax_bits[g, ax] = slots.index(off), code & 3
        slot_plane[g], nslot[g] = slots, len(slots)
        if slots:
            order.append(g)
    last = [k == len(order) - 1 or order[k + 1] // A != order[k] // A
            for k in range(len(order))]
    return slot_plane, ax_slot, ax_bits, nslot, order, last


def _emulate_exact(plan, planes):
    """The exact forms' march (``galerkin_product_kernel_exact``), block by
    block, fine plane by fine plane and a_z by a_z (lanes, warps and staged
    rows as numpy axes), from the fine ``(P, Z, Y, X)`` float64 planes:
    every table row read in its window ``2 J - 1 .. 2 J + 2``, the
    compiled-in interior row (``cg.interior_row``) on interior x tiles, y
    rows and z planes, the tables' rows elsewhere, the staged tile zero past
    the grid."""
    A, O, T = plan.A, plan.O, cg.TAPS
    nz, ny, nx = plan.fine_shape
    cz, cy, cx = plan.coarse_shape
    assert (nz, ny, nx) == (2 * cz, 2 * cy, 2 * cx)
    kw = T * A * O
    w = cg.kernel_weights(plan).astype(np.float64)
    wz = w[:cz * kw].reshape(cz, T, A, O)
    wy = w[cz * kw:(cz + cy) * kw].reshape(cy, T, A, O)
    wx = w[(cz + cy) * kw:].reshape(kw, cx).T.reshape(cx, T, A, O)  # stored transposed
    row = cg.interior_row(A, O).astype(np.float64)
    runs = plan.runs
    codes = plan.fine.reshape(A, A, A)
    ty, tx = cg.EXACT_TILE_Y, cg.TILE_X
    out = np.full((len(plan.offsets), cz, cy, cx), np.nan)
    lane = np.arange(tx)
    for z0, by, bx in itertools.product(range(0, cz, plan.zchunk), range(-(-cy // ty)),
                                        range(-(-cx // tx))):
        z1 = min(z0 + plan.zchunk, cz)
        x0, y0 = bx * tx, by * ty
        jx, jy = x0 + lane, y0 + np.arange(ty)
        jxc, jyc = np.minimum(jx, cx - 1), np.minimum(jy, cy - 1)
        # the staged tile: fine rows 2 y0 - 1 .., a lane's taps its fine
        # columns 2 jx - 1 .. 2 jx + 2 (staged from 2 x0 - 4)
        fy = 2 * y0 - 1 + np.arange(2 * ty + 2)
        fx = (2 * x0 - cg.ALIGN) + (2 * lane + 2)[:, None] + 1 + np.arange(T)  # (lane, t)
        ok = (((fy >= 0) & (fy < ny))[:, None, None]
              & ((fx >= 0) & (fx < nx))[None])                               # (row, lane, t)
        fyc, fxc = np.clip(fy, 0, ny - 1), np.clip(fx, 0, nx - 1)
        xborder = x0 < runs[2] or x0 + tx > runs[3]
        yborder = (jyc < runs[0]) | (jyc >= runs[1])
        hx = wx[jxc] if xborder else np.broadcast_to(row, (tx, T, A, O))     # (lane, t, a, o)
        hy = np.where(yborder[:, None, None, None], wy[jyc], row[None])        # (warp y, t, a, o)
        acc0 = np.zeros((ty, O, O, O, tx))   # (warp y, o_z, o_y, o_x, lane)
        acc1 = np.zeros_like(acc0)
        izs, ize = max(2 * z0 - 1, 0), min(2 * z1, nz - 1)
        for iz in range(izs, ize + 1):
            odd = iz % 2 == 1
            cur = iz // 2 if odd else iz // 2 - 1  # iz feeds coarse planes cur, cur + 1
            zin = cur >= runs[4] and cur + 1 < runs[5]
            t0 = 2 if odd else 3
            for az in range(A):
                # x stage: u[row, a_y, o_x, lane] of the staged values (zero
                # past the grid), s = -c off the centre, 1 - c on it
                s_ = np.zeros((A, A, len(fy), tx, T))
                for ay, ax in itertools.product(range(A), range(A)):
                    code = int(codes[az, ay, ax])
                    if code < 0:
                        continue
                    v = np.where(ok, planes[code >> 2, iz][fyc[:, None, None], fxc[None]], 0.0)
                    s_[ay, ax] = (-v if code & 2 else v) + (1.0 if code & 1 else 0.0)
                u = np.einsum("ltao,yarlt->ryol", hx, s_)
                # y stage: each warp's coarse y, its fine rows 2 jy - 1 + t
                v = np.zeros((ty, O, O, tx))  # (warp y, o_y, o_x, lane)
                for yl in range(ty):
                    v[yl] = np.einsum("tap,taol->pol", hy[yl], u[2 * yl:2 * yl + T])
                # z stage: the two coarse planes iz feeds
                if zin:
                    h0, h1 = row[t0, az], row[t0 - 2, az]
                else:
                    h0 = wz[cur, t0, az] if cur >= 0 else np.zeros(O)
                    h1 = wz[cur + 1, t0 - 2, az] if cur + 1 < cz else np.zeros(O)
                acc0 += h0[None, :, None, None, None] * v[:, None]
                acc1 += h1[None, :, None, None, None] * v[:, None]
            done = (cur if not odd and cur >= z0 else None,
                    iz // 2 if odd and iz == ize else None)
            for jz in done:
                if jz is None:
                    continue
                for oz, oy, ox in itertools.product(range(O), repeat=3):
                    p = plan.out_map[oz, oy, ox]
                    if p < 0:
                        continue
                    val = -acc0[:, oz, oy, ox]
                    if (oz, oy, ox) == (2, 2, 2):
                        val = 1.0 + val
                    for yl in np.nonzero(jy < cy)[0]:
                        live = jx < cx
                        assert np.isnan(out[p, jz, jy[yl], jx[live]]).all()
                        out[p, jz, jy[yl], jx[live]] = val[yl, live]
            if not odd:
                acc0, acc1 = acc1, np.zeros_like(acc1)
    return out


def _emulate(plan, planes):
    """The kernel's arithmetic, block by block and step by step (lanes and
    warps as numpy axes), from the fine ``(P, Z, Y, X)`` float64 planes;
    the exact forms' march for their plans (:func:`_emulate_exact`)."""
    if plan.form.startswith("exact"):
        return _emulate_exact(plan, planes)
    A, O = plan.A, plan.O
    noz = 3 if O == 3 else 1
    npass = O // noz
    nz, ny, nx = plan.fine_shape
    cz, cy, cx = plan.coarse_shape
    kw = cg.TAPS * A * O
    rows, cols = cg.ROWS, cg.COLS
    s = plan.starts
    zs, ys, xs, zl = s[:cz], s[cz:cz + cy], s[cz + cy:cz + cy + cx], s[cz + cy + cx:]
    w = cg.kernel_weights(plan).astype(np.float64)
    wz = w[:cz * kw].reshape(cz, kw)
    wy = w[cz * kw:(cz + cy) * kw].reshape(cy, kw)
    wx = w[(cz + cy) * kw:].reshape(kw, cx).T            # stored transposed
    iy, ix = plan.interior[:2].reshape(2, kw).astype(np.float64)
    runs = plan.runs
    flat = planes.reshape(-1)
    plane_elems = nz * ny * nx
    slot_plane, ax_slot, ax_bits, nslot, order, _ = _params(plan, planes.shape[0],
                                                            plane_elems)
    out = np.full((len(plan.offsets), cz, cy, cx), np.nan)
    lane = np.arange(cg.TILE_X)
    warp = np.arange(cg.TILE_Y)  # the warps of the y stage
    chunks = -(-cz // plan.zchunk)
    for bz, by, bx in itertools.product(range(chunks * npass), range(-(-cy // cg.TILE_Y)),
                                        range(-(-cx // cg.TILE_X))):
        pas, z0 = bz % npass, (bz // npass) * plan.zchunk
        z1 = min(z0 + plan.zchunk, cz)
        x0, y0 = bx * cg.TILE_X, by * cg.TILE_Y
        jx, jy = x0 + lane, y0 + warp
        jxc, jyc = np.minimum(jx, cx - 1), np.minimum(jy, cy - 1)
        xbase = int(xs[x0]) & ~(cg.ALIGN - 1)
        ybase = int(ys[y0])
        kx, ky = xs[jxc] - xbase, ys[jyc] - ybase
        kb, odd = kx & ~1, (kx & 1).astype(bool)
        xborder = x0 < runs[2] or x0 + cg.TILE_X > runs[3]
        yborder = (jyc < runs[0]) | (jyc >= runs[1])
        # border tiles and warps read their rows whole, the others the
        # interior row
        hx = wx[jxc] if xborder else np.broadcast_to(ix, (cg.TILE_X, kw))  # (32, kw)
        hy = np.where(yborder[:, None], wy[jyc], iy[None, :])               # (7, kw)
        acc0 = np.zeros((cg.TILE_Y, cg.TILE_X, noz * O * O))
        acc1 = np.zeros_like(acc0)
        jz = z0
        r_idx, c_idx = ybase + np.arange(rows), xbase + np.arange(cols)
        ok = (r_idx[:, None] < ny) & (c_idx[None, :] < nx)
        for iz in range(int(zs[z0]), int(zs[z1 - 1] + zl[z1 - 1])):
            for az in range(A):
                groups = [g for g in order if g // A == az]
                if not groups:
                    continue
                u = np.zeros((rows, A, O, cg.TILE_X))
                for g in groups:
                    tile = np.zeros((A, rows, cols))
                    for slot, off in enumerate(slot_plane[g]):
                        idx = (off + (iz * ny + np.minimum(r_idx, ny - 1))[:, None] * nx
                               + np.minimum(c_idx, nx - 1)[None, :])
                        tile[slot] = np.where(ok, flat[idx], 0.0)
                    for r in range(rows):
                        part = np.zeros((cg.TILE_X, O))
                        for ax in range(A):
                            slot = ax_slot[g, ax]
                            if slot < 0:
                                continue
                            pairs = tile[slot, r, kb[:, None] + np.arange(6)]
                            taps = [np.where(odd, pairs[:, t + 1], pairs[:, t])
                                    for t in range(cg.TAPS)]
                            cw = [slice((t * A + ax) * O, (t * A + ax + 1) * O)
                                  for t in range(cg.TAPS)]
                            total = sum(hx[:, cw[t]] * taps[t][:, None] for t in range(cg.TAPS))
                            part += -total if ax_bits[g, ax] & 2 else total
                            if ax_bits[g, ax] & 1:
                                part += sum(hx[:, cw[t]] for t in range(cg.TAPS))
                        u[r, g % A] = part.T
                # y stage: rows past the tile carry no weight
                v = np.zeros((cg.TILE_Y, cg.TILE_X, O * O))
                for ty, a, oy in itertools.product(range(cg.TAPS), range(A), range(O)):
                    r = np.minimum(ky + ty, rows - 1)
                    v[:, :, oy * O:(oy + 1) * O] += (hy[:, (ty * A + a) * O + oy][:, None, None]
                                                     * np.moveaxis(u[r, a], 1, 2))
                for acc, jj in ((acc0, jz), (acc1, jz + 1)):
                    t = iz - zs[jj] if jj < z1 else -1
                    if 0 <= t < cg.TAPS:
                        for oz in range(noz):
                            h = wz[jj, (t * A + az) * O + pas * noz + oz]
                            acc[:, :, oz * O * O:(oz + 1) * O * O] += h * v
            if iz == zs[jz] + zl[jz] - 1:
                live = (jy[:, None] < cy) & (jx[None, :] < cx)
                yy, xx = np.nonzero(live)
                for oz, oy, ox in itertools.product(range(noz), range(O), range(O)):
                    p = plan.out_map[pas * noz + oz, oy, ox]
                    if p < 0:
                        continue
                    val = -acc0[:, :, (oz * O + oy) * O + ox]
                    if (pas * noz + oz, oy, ox) == (O // 2,) * 3:
                        val = 1.0 + val
                    out[p, jz, jy[yy], jx[xx]] = val[yy, xx]
                acc0, acc1 = acc1, np.zeros_like(acc1)
                jz += 1
        assert jz == z1
    return out


@pytest.mark.parametrize("shape,form,collapse,levels", [
    ((16, 12, 264), "compressed", False, 2),
    ((12, 8, 132), "random125", False, 1),
    ((12, 14, 20), "compressed", False, 1),
    ((16, 16, 16), "compressed", True, 2),
    ((17, 17, 17), "stored", False, 2),
    ((12, 10, 9), "compressed", False, 2),
    ((4, 9, 8), "stored", True, 1),
    ((8, 40, 70), "compressed", True, 1),
    ((13, 18, 66), "stored", False, 1),
    ((11, 41, 35), "stored", True, 1),
], ids=str)
def test_emulated_kernel_matches_the_eager_path(shape, form, collapse, levels):
    """The kernel's march, emulated, writes every output value once and
    agrees with the eager path: compressed and stored fine operators,
    radius 1 and (the exact variant's second level) radius 2, both
    variants, cell and vertex axes (a vertex axis's last row one further),
    several x and y tiles, z chunks; the exact forms' march on the exact
    chain's three tables (exact19, exact117 and exact125), with interior
    and border x tiles, y rows and z planes, partial tiles."""
    op = _fine_op(shape, form)
    forms = []
    for _ in range(levels):
        cent = _centering(op.shape)
        plan = _plan(op, cent, collapse)
        forms.append(plan.form)
        offsets, planes, _ = galerkin.plane_table(op)
        got = _emulate(plan, planes.numpy())
        assert not np.isnan(got).any()
        want = galerkin.assemble_galerkin_parabolic(op, cent, collapse=collapse)
        err = np.abs(got - want.coeffs.numpy()).max() / want.diag.abs().max().item()
        assert err <= 1e-12
        op = want
    if not collapse and all(n % 2 == 0 for n in shape):
        assert forms == (["exact125"] if form == "random125"
                         else ["exact19", "exact117"][:levels])


@pytest.mark.parametrize("shape", [(512,) * 3, (69, 77, 69), (65, 65, 65), (48, 40, 36),
                                   (254, 256, 256)], ids=str)
@pytest.mark.parametrize("collapse", [True, False], ids=["collapsed", "exact"])
def test_plan_fits_the_kernel_on_every_level(shape, collapse):
    """Every Galerkin level of these hierarchies plans within the kernel's
    tile and march (``_check_geometry``), its launch grid within the card's
    limits, and the fine and output tables within the kernel's sizes."""
    radius = 1
    for lvl, plan in _chain_plans(shape, collapse):
        assert plan.coarse_shape == lvl.shape
        assert plan.A == 2 * radius + 1 and plan.O in (3, 5)
        npass = 1 if plan.O == 3 or plan.form.startswith("exact") else plan.O
        assert math.ceil(lvl.shape[0] / plan.zchunk) * npass <= 65535
        assert 1 <= plan.zchunk <= lvl.shape[0]
        radius = max(abs(o) for off in plan.offsets for o in off)


def _chain_plans(shape, collapse):
    """``(level, plan)`` of each Galerkin level of ``shape``'s hierarchy:
    level 1 from the compressed operator's 19 offsets, each level below
    from the one above's planes as a stored operator."""
    levels = build_level_descriptors(shape)
    op = compressed.CompressedDCAOperator(torch.zeros((10, 1, 1, 1)), 3)
    offsets, _, terms = galerkin.plane_table(op)
    fine = levels[0].shape
    for lvl in levels[1:]:
        plan = cg.product_plan(fine, lvl.centering, offsets, terms, collapse)
        yield lvl, plan
        offsets = plan.offsets
        terms = tuple((k, 1.0) for k in range(len(offsets)))
        fine = lvl.shape


@pytest.mark.parametrize("shape,collapse,forms", [
    ((512,) * 3, False, ["exact19", "exact117"] + ["exact125"] * 4),
    ((512,) * 3, True, ["compressed19"] + ["stored27"] * 5),
    ((128,) * 3, False, ["exact19", "exact117", "exact125", "exact125"]),
    ((254, 256, 256), False, ["exact19", "generic"] + ["exact125"] * 3),
    ((254, 256, 256), True, ["compressed19"] + ["stored27"] * 4),
    ((69, 77, 69), False, ["generic"] * 3),
    ((69, 77, 69), True, ["generic", "generic", "stored27"]),
    ((40, 36, 33), False, ["generic"] * 2),
], ids=str)
def test_plan_names_each_levels_form(shape, collapse, forms):
    """The form each level's plan names: the exact chain's exact19 (the
    compressed operator -> 117 planes), exact117, then exact125 on
    cell-centred levels; the collapsed chain's compressed19, then stored27,
    as before the exact forms; ``generic`` where a level or the one above
    has a vertex-centred (odd) axis."""
    assert [plan.form for _, plan in _chain_plans(shape, collapse)] == forms


def test_pruned_and_other_tables_take_the_generic_form():
    """A pruned exact level (``galerkin_prune_tol > 0``) and radius-2
    operators that are not the exact chain's fall to the generic form, as
    do the collapsed variant of the exact chain's tables."""
    op = _fine_op((16, 16, 16), "compressed")
    level = galerkin.assemble_galerkin_parabolic(op, (CELL,) * 3)
    assert _plan(level, (CELL,) * 3, False).form == "exact117"
    pruned = galerkin.prune_stored_operator(level, 1e-3)
    assert len(pruned.offsets) < len(level.offsets)
    assert _plan(pruned, (CELL,) * 3, False).form == "generic"
    assert _plan(level, (CELL,) * 3, True).form == "generic"
    # the 5^3 box in another order, and without one off-centre plane
    box = _fine_op((8, 8, 8), "random125")
    flipped = StencilOperator(box.coeffs.flip(0), box.offsets[::-1])
    assert _plan(box, (CELL,) * 3, False).form == "exact125"
    assert _plan(flipped, (CELL,) * 3, False).form == "generic"
    short = StencilOperator(box.coeffs[1:], box.offsets[1:])
    assert _plan(short, (CELL,) * 3, False).form == "generic"


@pytest.mark.parametrize("shape", [(512,) * 3, (254, 256, 256), (16, 16, 16)], ids=str)
@pytest.mark.parametrize("collapse", [True, False], ids=["collapsed", "exact"])
def test_compiled_in_rows_are_each_levels_interior_rows(shape, collapse):
    """The interior rows the compiled-in forms carry (``cg.interior_row``,
    the kernel's ``cell_weight`` and ``exact_weight`` mirrored) equal the
    plan's rows from ``pair_rows`` on every level's interior run, on each
    axis the form reads them on; each exact level's tables, re-indexed to
    their windows (``window_table``), hold that row on the run and zeros
    outside its non-zero entries everywhere."""
    for lvl, plan in _chain_plans(shape, collapse):
        if plan.form == "generic":
            continue
        row = cg.interior_row(plan.A, plan.O)
        exact = plan.form.startswith("exact")
        for k in range(3 if exact else 2):
            lo, hi = plan.runs[2 * k], plan.runs[2 * k + 1]
            if lo < hi:
                np.testing.assert_array_equal(plan.interior[k], row)
        if not exact:
            continue
        cz, cy, cx = plan.coarse_shape
        s, w = plan.starts, plan.weights
        for k, (a, b) in enumerate(((cz, cz + cy), (cz + cy, cz + cy + cx), (0, cz))):
            win = cg.window_table(s[a:b], w[a:b])
            lo, hi = plan.runs[2 * k], plan.runs[2 * k + 1]  # y, x, z
            for j in range(lo, hi):
                np.testing.assert_array_equal(win[j], row)
            assert not (win != 0)[:, row == 0].any()


@pytest.mark.parametrize("fine_n,centering", [(512, CELL), (65, VERTEX), (9, VERTEX),
                                              (4, CELL), (66, CELL)])
def test_interior_rows_hold_on_their_runs(fine_n, centering):
    """The y and x tables' interior row holds on its run (rows starting at
    ``2 J - 1``); the run covers all but the borders on a long axis."""
    for rf, collapse in ((1, True), (1, False), (2, False)):
        rc = (3 + rf) // 2 if centering == CELL else (2 + rf) // 2
        ro = 1 if collapse else 2
        starts, _, w = cg.axis_table(fine_n, centering, rf, rc, 2, ro, collapse)
        row, lo, hi = cg.interior_run(starts, w)
        for j in range(lo, hi):
            assert starts[j] == 2 * j - 1
            np.testing.assert_array_equal(w[j], row)
        if len(starts) >= 8:
            assert lo <= 2 and hi >= len(starts) - 2


def test_wrapper_takes_the_plain_version_on_the_cpu_and_refuses_2d():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; ``kernel_takes`` leaves CPU, 2D and matrix-free operators to
    the eager paths; a 2D operator is refused."""
    op = _fine_op((8, 8, 8), "compressed")
    before = cg.cuda_galerkin_product.launches.copy()
    got = cg.cuda_galerkin_product(op, (CELL,) * 3, True)
    want = galerkin.assemble_galerkin_parabolic(op, (CELL,) * 3, collapse=True,
                                                use_kernels=True)
    assert _rel_err(got, want) <= 1e-12
    assert cg.cuda_galerkin_product.launches == before
    assert not cg.kernel_takes(op)
    mat = make_spd_tensor_field(np.random.default_rng(1), (8, 8), 2, hi=3.0)
    op2 = compressed.assemble_compressed_dca(as_sym_planes(mat, (8, 8)), (1.0, 1.0), DT)
    assert not cg.kernel_takes(op2)
    with pytest.raises(ValueError):
        cg.cuda_galerkin_product(op2, (CELL,) * 2, True)
    t = as_sym_planes(make_spd_tensor_field(np.random.default_rng(2), (8,) * 3, 3), (8,) * 3)
    assert not cg.kernel_takes(MatrixFreeDCAOperator(t, (1.0,) * 3, DT))
