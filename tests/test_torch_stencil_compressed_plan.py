"""The compressed-operator stencil kernel (B1/B2, and B14's shard-local
form) as the host plans and the kernel computes it, on the CPU.

``ops.cuda_smoothers.launch_geometry`` is the kernel's launch: a block owns
``TILE_Y`` rows x ``TILE_X`` columns and a run of z planes, a warp a row, a
lane ``VEC`` consecutive cells.  The tests hold that geometry to cover every
cell of odd shapes and of each level of the solves' hierarchies exactly
once, ``check_grid`` to refuse what it cannot launch, and an emulation of
the kernel's arithmetic to the plain versions' bytes: per block and plane,
x staged in ring planes as the kernel stages it (zero outside the grid, each
row's column phases apart), each cell's 18 neighbours read at the kernel's
ring offsets, the terms in ``offdiag_apply``'s order, every product, sum
and the division rounded on its own in the compute dtype; the shard-local
form zeroes the coefficients from the cell's position in the block as
``_mask_local_shells`` does.  float32, bfloat16 storage and float64."""

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.core.stencil import compute_dtype
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers as cs
from multigridanisotropicdiffusion_tpu_torch.ops.compressed import CompressedDCAOperator

DTYPES = [torch.float32, torch.bfloat16, torch.float64]
INTS = {2: torch.int16, 4: torch.int32, 8: torch.int64}
#: odd shapes: X not a multiple of 4, X < 128, Y below a tile's rows, Z = 1, 2
ODD = [(1, 5, 3), (2, 9, 130), (3, 7, 127), (5, 17, 4), (2, 3, 133), (9, 10, 64)]
LEVEL_SHAPES = sorted({lvl.shape for n in ((512,) * 3, (69, 77, 69))
                       for lvl in build_level_descriptors(n)})


def _bits(t):
    return t.contiguous().view(INTS[t.element_size()])


def _axis_counts(n, blocks, per_block, sub):
    """How often each index of an axis of n is a cell of some (block, lane
    position, cell) of the launch: block k, position p and cell j give
    k * per_block + sub * p + j; those >= n are masked off."""
    k, p, j = np.meshgrid(np.arange(blocks), np.arange(per_block // sub), np.arange(sub),
                          indexing="ij")
    idx = (k * per_block + sub * p + j).ravel()
    return np.bincount(idx[idx < n], minlength=n)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", ODD + LEVEL_SHAPES, ids=str)
def test_launch_geometry_covers_every_cell_once(shape, dtype):
    nz, ny, nx = shape
    zrun, (gx, gy, gz) = cs.launch_geometry(shape, dtype)
    assert 1 <= zrun <= max(nz, cs.MAX_RUN) and gz == -(-nz // zrun)
    assert min(zrun, nz) == zrun and (zrun >= min(cs.MIN_RUN, nz))
    assert gy <= cs.MAX_GRID_Y and gz <= cs.MAX_GRID_Z
    # the cells of the launch are the product of the three axes' indices:
    # each index of each axis once makes every cell once
    assert (_axis_counts(nx, gx, cs.TILE_X, cs.VEC) == 1).all()
    assert (_axis_counts(ny, gy, cs.TILE_Y[dtype], 1) == 1).all()
    assert (_axis_counts(nz, gz, zrun, 1) == 1).all()
    # no block lies wholly outside the field
    assert (gx - 1) * cs.TILE_X < nx and (gy - 1) * cs.TILE_Y[dtype] < ny
    assert (gz - 1) * zrun < nz


def test_launch_geometry_fills_the_card():
    """The solves' 512^3 level: 16384 blocks of 8 planes; a rank's block
    and the coarse levels run 4 planes a block, the shortest run."""
    assert cs.launch_geometry((512,) * 3, torch.float32) == (8, (4, 64, 64))
    assert cs.launch_geometry((256, 512, 512), torch.bfloat16) == (4, (4, 64, 64))
    assert cs.launch_geometry((512,) * 3, torch.float64) == (16, (4, 128, 32))
    assert cs.launch_geometry((64,) * 3, torch.float32) == (4, (1, 8, 16))
    assert cs.launch_geometry((2048,) * 3, torch.float32) == (64, (16, 256, 32))
    assert cs.launch_geometry((2, 2, 2), torch.float32) == (2, (1, 1, 1))
    # a deep field: runs lengthen so that the grid's z extent stays a launch's
    zrun, grid = cs.launch_geometry((65535 * 64 + 1, 1, 1), torch.float32)
    assert zrun == 65 and grid == (1, 1, 64527)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", ODD + LEVEL_SHAPES, ids=str)
def test_sweep_geometry_covers_every_cell_once(shape, dtype):
    """The fused sweep's plan (B17): the tile of the half-sweeps, runs of
    ``[SWEEP_MIN_RUN, SWEEP_MAX_RUN]`` planes (at most ``Z``), each cell in
    one block, a grid within the launch limits."""
    nz, ny, nx = shape
    zrun, (gx, gy, gz) = cs.launch_geometry(shape, dtype, sweep=True)
    assert 1 <= zrun <= max(nz, cs.SWEEP_MAX_RUN) and gz == -(-nz // zrun)
    assert zrun <= nz and zrun >= min(cs.SWEEP_MIN_RUN, nz)
    assert gy <= cs.MAX_GRID_Y and gz <= cs.MAX_GRID_Z
    assert (_axis_counts(nx, gx, cs.TILE_X, cs.VEC) == 1).all()
    assert (_axis_counts(ny, gy, cs.TILE_Y[dtype], 1) == 1).all()
    assert (_axis_counts(nz, gz, zrun, 1) == 1).all()
    assert (gx - 1) * cs.TILE_X < nx and (gy - 1) * cs.TILE_Y[dtype] < ny
    assert (gz - 1) * zrun < nz


def test_sweep_geometry_at_the_solves_sizes():
    """Longer runs than the half-sweeps': the two planes a block's red pass
    adds at the ends of its run are a small share of its reads, and the
    deep field's runs still lengthen so that the grid's z extent stays a
    launch's."""
    assert cs.launch_geometry((512,) * 3, torch.float32, sweep=True) == (256, (4, 64, 2))
    assert cs.launch_geometry((512,) * 3, torch.bfloat16, sweep=True) == (256, (4, 64, 2))
    assert cs.launch_geometry((256,) * 3, torch.bfloat16, sweep=True) == (128, (2, 32, 2))
    assert cs.launch_geometry((128,) * 3, torch.float32, sweep=True) == (16, (1, 16, 8))
    assert cs.launch_geometry((64,) * 3, torch.float32, sweep=True) == (8, (1, 8, 8))
    assert cs.launch_geometry((8,) * 3, torch.float32, sweep=True) == (8, (1, 1, 1))
    assert cs.launch_geometry((5, 17, 260), torch.float64, sweep=True) == (5, (3, 5, 1))
    zrun, grid = cs.launch_geometry((65535 * 256 + 1, 1, 1), torch.float32, sweep=True)
    assert zrun == 257 and grid == (1, 1, 65281)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rbgs_sweep_on_cpu_is_the_plain_sweep(dtype):
    """On CPU tensors ``rbgs_sweep`` is the plain sweep, red then black,
    bit for bit, and launches nothing."""
    for shape in ((1, 5, 3), (2, 9, 130), (5, 10, 133)):
        op, x, b = _inputs(shape, dtype, seed=3 * sum(shape))
        want = cs.halfsweep_plain(op, cs.halfsweep_plain(op, x, b, 0), b, 1)
        before = cs.launches.copy()
        got = cs.rbgs_sweep(op, x, b)
        assert cs.launches == before
        assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(cs.rbgs_sweep_plain(op, x, b)), _bits(want))


def test_check_grid_refuses_what_the_grid_cannot_launch():
    """``_check``'s grid test: the rows of a field beyond 65535 tiles (the
    z extent never is: runs lengthen instead)."""
    cs.check_grid("t", (1, 65535 * 8, 4), torch.float32)
    cs.check_grid("t", (3, 65535 * 4, 4), torch.float64)
    cs.check_grid("t", (65535 * 64 + 1, 1, 4), torch.bfloat16)
    for shape, dtype in (((1, 65535 * 8 + 1, 4), torch.float32),
                         ((1, 65535 * 8 + 1, 4), torch.bfloat16),
                         ((2, 65535 * 4 + 1, 4), torch.float64)):
        with pytest.raises(ValueError):
            cs.check_grid("t", shape, dtype)
    op = CompressedDCAOperator(torch.zeros((6, 4, 4)), 2)
    with pytest.raises(ValueError, match="3D"):
        cs._check("t", op, torch.zeros((4, 4)), torch.zeros((4, 4)), local=True)


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------


def _staged_plane(xc, zz, y0, x0, rows):
    """One ring plane as the kernel stages it (radius 1): rows y0 - 1 ..
    y0 - 2 + rows; column q of a row (tile column q - VEC) at phase q mod
    VEC, index q // VEC; zero outside the grid; NaN where nothing is
    staged."""
    nz, ny, nx = xc.shape
    q = torch.arange(cs.ROW)
    gx = x0 + q - cs.VEC
    gy = y0 - 1 + torch.arange(rows)
    plane = torch.zeros((rows, cs.ROW), dtype=xc.dtype)
    if 0 <= zz < nz:
        inside = ((gy >= 0) & (gy < ny))[:, None] & ((gx >= 0) & (gx < nx))[None, :]
        vals = xc[zz][gy.clamp(0, ny - 1)][:, gx.clamp(0, nx - 1)]
        plane = torch.where(inside, vals, plane)
    plane[:, (q < cs.VEC - 1) | (q > cs.VEC + cs.TILE_X)] = float("nan")
    stored = torch.zeros_like(plane)
    stored[:, (q % cs.VEC) * cs.PHASE + q // cs.VEC] = plane
    return stored.reshape(-1)


def _emulate(op, x, b, color=None, local=False):
    """The kernel's output: the half-sweep of ``color``, or the residual
    (``color`` None), block by block and plane by plane as launched."""
    cd = compute_dtype(x.dtype)
    nz, ny, nx = op.shape
    zrun, (gx, gy, gz) = cs.launch_geometry(op.shape, x.dtype)
    ty = cs.TILE_Y[x.dtype]
    planes, xc, bc = op.planes.to(cd), x.to(cd), b.to(cd)
    out = torch.full(op.shape, float("nan"), dtype=cd)
    writes = torch.zeros(op.shape, dtype=torch.int64)
    w, lane, j = torch.meshgrid(torch.arange(ty), torch.arange(cs.TILE_X // cs.VEC),
                                torch.arange(cs.VEC), indexing="ij")
    base = (w + 1) * cs.ROW + lane
    zero = torch.zeros((), dtype=cd)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                y0, x0 = by * ty, bx * cs.TILE_X
                cy, cx = y0 + w, x0 + cs.VEC * lane + j
                cell = (cy < ny) & (cx < nx)
                cy, cx, cj, cb = cy[cell], cx[cell], j[cell], base[cell]
                for z in range(bz * zrun, min((bz + 1) * zrun, nz)):
                    ring = {dz: _staged_plane(xc, z + dz, y0, x0, ty + 2) for dz in (-1, 0, 1)}

                    def X(dz, dy, dx):
                        off = torch.as_tensor([cs.ring_offset(dy, dx, i)
                                               for i in range(cs.VEC)])
                        return ring[dz][cb + off[cj]]

                    cf = planes[:, z, cy, cx]
                    if local:
                        zlo, zhi = torch.full(cy.shape, z > 0), torch.full(cy.shape, z < nz - 1)
                        ylo, yhi = cy > 0, cy < ny - 1
                        xlo, xhi = cx > 0, cx < nx - 1
                        keep = [zhi, zlo, yhi, ylo, xhi, xlo,
                                zlo & zhi & ylo & yhi, zlo & zhi & xlo & xhi,
                                ylo & yhi & xlo & xhi]
                        cf = torch.stack([torch.where(k, p, zero) for k, p in zip(keep, cf)] + [cf[9]])
                    off = cf[0] * X(1, 0, 0) + cf[1] * X(-1, 0, 0)
                    off = off + (cf[2] * X(0, 1, 0) + cf[3] * X(0, -1, 0))
                    off = off + (cf[4] * X(0, 0, 1) + cf[5] * X(0, 0, -1))
                    for p, (a, c) in ((6, (0, 1)), (7, (0, 2)), (8, (1, 2))):
                        def d(sa, sc):
                            o = [0, 0, 0]
                            o[a], o[c] = sa, sc
                            return X(*o)
                        off = off + cf[p] * (((d(1, 1) - d(1, -1)) - d(-1, 1)) + d(-1, -1))
                    xv, bv, dv = X(0, 0, 0), bc[z, cy, cx], cf[9]
                    if color is None:
                        res = (bv - dv * xv) - off
                    else:
                        on = (z + cy + cx) % 2 == color
                        res = torch.where(on, (bv - off) / dv, xv)
                    out[z, cy, cx] = res
                    writes[z, cy, cx] += 1
    assert (writes == 1).all()
    return out.to(x.dtype)


def _inputs(shape, dtype, seed):
    """Random planes, non-zero on every border (so the shard-local masking
    matters at every block face), with signed zeros; x with zeros."""
    rng = np.random.default_rng(seed)
    planes = torch.as_tensor(rng.normal(size=(10, *shape)))
    planes[:9, torch.as_tensor(rng.random(shape) < 0.05)] = -0.0
    planes[9] = 8.0 + planes[9].abs()
    x = torch.as_tensor(rng.normal(size=shape) * 10.0)
    x[torch.as_tensor(rng.random(shape) < 0.05)] = 0.0
    b = torch.as_tensor(rng.normal(size=shape) * 10.0)
    return CompressedDCAOperator(planes.to(dtype), 3), x.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1, 5, 3), (2, 9, 130), (5, 10, 133), (3, 17, 8)], ids=str)
@pytest.mark.parametrize("form", ["halfsweep0", "halfsweep1", "residual"])
def test_emulation_matches_plain_bitwise(form, shape, dtype):
    op, x, b = _inputs(shape, dtype, seed=sum(shape))
    if form == "residual":
        want = cs.residual_plain(op, x, b)
        got = _emulate(op, x, b)
    else:
        color = int(form[-1])
        want = cs.halfsweep_plain(op, x, b, color)
        got = _emulate(op, x, b, color)
    assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1, 5, 3), (2, 9, 130), (5, 10, 133), (4, 3, 7)], ids=str)
@pytest.mark.parametrize("form", ["halfsweep0", "halfsweep1", "residual"])
def test_local_emulation_matches_plain(form, shape, dtype):
    op, x, b = _inputs(shape, dtype, seed=2 * sum(shape))
    if form == "residual":
        want = cs.residual_local_plain(op, x, b)
        got = _emulate(op, x, b, local=True)
    else:
        color = int(form[-1])
        want = cs.halfsweep_local_plain(op, x, b, color)
        got = _emulate(op, x, b, color, local=True)
    assert got.dtype == want.dtype and torch.equal(got, want)
