"""The stored-operator and 2D stencil kernels (B12, B13) against their plain
PyTorch versions on the card, the Galerkin product kernel (B16) against the
eager Galerkin path, and the Galerkin and 2D solves through them.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one;
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_galerkin.py``
runs them on a machine with a card.  The random operators carry nonzero
coefficients on the offsets that leave the grid: the kernels must skip those
terms as the plain versions' zero padding does.  B12 and B13's stored form
round every product and sum as their plain versions do and are held to
their bytes (an integer comparison: signed zeros included), in every dtype,
on the compiled layouts (19, 27, 117, 125 planes; 9 in 2D), pruned
operators in their own order (the generic loop), widths that are whole
4-cell vectors and widths that are not, shapes that are not whole tiles and
runs of z planes longer and shorter than a block's.  B13's compressed form
keeps the tolerances of ``tests/test_torch_cuda.py``: float64 1e-12 and
float32 1e-5 of the largest reference value, bf16 one bf16 ulp of each
value with the float32 floor.  B16 sums in another order than the eager
path: float64 within 1e-12 and float32 within 1e-6 of the largest diagonal
value, against the eager path in float64 on the same planes.
"""

import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.core.grids import CELL, build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.core.stencil import StencilOperator, stencil_offsets
from multigridanisotropicdiffusion_tpu_torch.models import mad
from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
from multigridanisotropicdiffusion_tpu_torch.ops import (
    compressed,
    cuda_galerkin,
    cuda_smoothers,
    cuda_transfer,
    galerkin,
    transfer,
)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float64, torch.float32, torch.bfloat16]
INTS = {2: torch.int16, 4: torch.int32, 8: torch.int64}
#: the stencil kernels' counts: the sum of these ``cuda_smoothers.launches``
#: keys
STENCIL = {
    "b17_sweep": (("compressed", "sweep"),),
    "b12_halfsweep": (("stored", "halfsweep"),),
    "b12_residual": (("stored", "residual"),),
    "b13_halfsweep": (("2d_compressed", "halfsweep"), ("2d_stored", "halfsweep")),
    "b13_residual": (("2d_compressed", "residual"), ("2d_stored", "residual")),
}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.double(), want.double()
    scale = w.abs().max().item()
    err = (g - w).abs()
    assert bool(torch.isfinite(g).all())
    if want.dtype == torch.bfloat16:
        a = w.abs().clamp_min(torch.finfo(torch.float32).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
        assert bool((err <= torch.maximum(ulp, torch.full_like(ulp, 1e-5 * scale))).all())
    else:
        tol = 1e-12 if want.dtype == torch.float64 else 1e-5
        assert err.max().item() <= tol * scale


def _check_bits(got, want):
    """The kernel's output is its plain version's bytes."""
    assert got.shape == want.shape and got.dtype == want.dtype
    ints = INTS[got.element_size()]
    differ = int((got.contiguous().view(ints) != want.contiguous().view(ints)).sum())
    assert differ == 0, f"{differ} of {got.numel()} values differ in their bits"


def _layout(name):
    """The offset tables the tests run: the solves' layouts, and a pruned
    radius-2 table (every other outer offset dropped) in a shuffled order."""
    if name in ("19", "27"):
        return stencil_offsets(3, 1, drop_corners=name == "19")
    if name == "117":  # level 1 of an exact hierarchy over the 19-point operator
        return galerkin._structural_offsets((CELL,) * 3, stencil_offsets(3, 1), (2, 2, 2))
    full = stencil_offsets(3, 2, drop_corners=False)
    if name == "125":
        return full
    keep = [o for i, o in enumerate(full) if i % 2 == 0 or max(map(abs, o)) <= 1]
    order = torch.randperm(len(keep), generator=torch.Generator().manual_seed(7))
    return tuple(keep[i] for i in order.tolist())


def _random_op(shape, radius, gen, device, drop_corners=False, offsets=None):
    """Random planes everywhere, borders included; a dominant diagonal."""
    if offsets is None:
        offsets = stencil_offsets(len(shape), radius, drop_corners=drop_corners)
    coeffs = torch.randn((len(offsets), *shape), generator=gen, device=device,
                         dtype=torch.float64) * 0.05
    c = offsets.index((0,) * len(shape))
    coeffs[c] = coeffs.abs().sum(0) + 1.0
    return StencilOperator(coeffs, offsets)


def _tensor(shape, gen, device):
    nd = len(shape)
    g = torch.randn((nd, nd, *shape), generator=gen, device=device)
    pairs = [(i, j) for i in range(nd) for j in range(i, nd)]
    return torch.stack([(g[i] * g[j]).sum(0) + (2.0 if i == j else 0.0) for i, j in pairs])


def _check_kernels(op, gen, dtype, exact=False):
    """Both half-sweeps and the residual against the plain versions: their
    bytes with ``exact``, else within the tolerances."""
    cs = cuda_smoothers
    op = op.astype(dtype)
    x = (torch.randn(op.shape, generator=gen, device="cuda", dtype=torch.float64) * 10).to(dtype)
    b = (torch.randn(op.shape, generator=gen, device="cuda", dtype=torch.float64) * 10).to(dtype)
    cmp = _check_bits if exact else _check
    for color in (0, 1):
        cmp(cs.halfsweep(op, x, b, color), cs.halfsweep_plain(op, x, b, color))
    cmp(cs.cuda_residual(op, x, b), cs.residual_plain(op, x, b))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("radius,drop_corners,shape", [
    (1, True, (9, 13, 35)), (1, False, (7, 10, 33)), (2, False, (6, 11, 37)),
    (2, False, (3, 4, 5)),
], ids=["19", "27", "125", "125-tiny"])
def test_b12_random_operators_match_plain(device, dtype, radius, drop_corners, shape):
    gen = torch.Generator(device=device).manual_seed(radius + len(shape))
    _check_kernels(_random_op(shape, radius, gen, device, drop_corners), gen, dtype,
                   exact=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout,shape", [
    ("19", (9, 13, 36)), ("27", (7, 10, 260)), ("117", (5, 9, 130)), ("117", (5, 9, 132)),
    ("125", (6, 11, 40)), ("pruned", (6, 12, 129)), ("pruned", (6, 12, 132)),
    ("27", (131, 70, 260)), ("19", (2, 300, 4)),
], ids=["19-vec", "27-vec-2-tiles", "117", "117-vec", "125-vec", "pruned", "pruned-vec",
        "27-long-z", "19-tall"])
def test_b12_layouts_and_shapes_match_plain_bitwise(device, dtype, layout, shape):
    """The compiled tap counts on whole-vector widths, the generic loop
    (pruned, and every width that is not whole vectors), shapes that are not
    whole tiles (x past 128 columns, y past 8 rows, 131 planes in runs of 4
    and a last run of 3)."""
    gen = torch.Generator(device=device).manual_seed(len(_layout(layout)) + shape[0])
    op = _random_op(shape, None, gen, device, offsets=_layout(layout))
    _check_kernels(op, gen, dtype, exact=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_b14_stored_on_galerkin_blocks_matches_plain(device, dtype):
    """The shard-local form (B12's kernel) on the blocks of a collapsed
    Galerkin level that a (2, 2, 1) mesh gives its ranks (odd and even
    origins), against the plain versions' masking: ``torch.equal`` (the
    plain version multiplies a masked 0 coefficient where the kernel
    multiplies by a 0 halo, so an exact zero may differ in sign)."""
    gen = torch.Generator(device=device).manual_seed(5)
    shape = (37, 41, 35)
    t = _tensor(shape, gen, device).double()
    hier = build_hierarchy(t, build_level_descriptors(shape), 0.1, "galerkin", "compressed",
                           galerkin_variant="collapsed")
    op = hier.operators[1].astype(dtype)
    nz, ny, _ = op.shape
    before = cuda_smoothers.launches.copy()
    for zs in (slice(0, nz // 2), slice(nz // 2, nz)):
        for ys in (slice(0, ny // 2 + 1), slice(ny // 2 + 1, ny)):
            block = StencilOperator(op.coeffs[:, zs, ys].contiguous(), op.offsets)
            x = (torch.randn(block.shape, generator=gen, device=device,
                             dtype=torch.float64) * 10).to(dtype)
            b = torch.randn(block.shape, generator=gen, device=device,
                            dtype=torch.float64).to(dtype)
            for color in (0, 1):
                assert torch.equal(
                    cuda_smoothers.halfsweep_local(block, x, b, color),
                    cuda_smoothers.halfsweep_local_plain(block, x, b, color))
            assert torch.equal(cuda_smoothers.cuda_residual_local(block, x, b),
                               cuda_smoothers.residual_local_plain(block, x, b))
    torch.cuda.synchronize()
    assert cuda_smoothers.launches - before == {("stored", "halfsweep_local"): 8,
                                                ("stored", "residual_local"): 4}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("variant", ["collapsed", "exact", "stored-dca"])
def test_b12_hierarchy_levels_match_plain(device, dtype, variant):
    """Every stored level of a (37, 41, 35) hierarchy (vertex, then cell
    coarsening)."""
    gen = torch.Generator(device=device).manual_seed(3)
    shape = (37, 41, 35)
    t = _tensor(shape, gen, device).double()
    kw = (dict(operator_repr="stored") if variant == "stored-dca" else
          dict(coarse_operator="galerkin", operator_repr="compressed",
               galerkin_variant=variant))
    hier = build_hierarchy(t, build_level_descriptors(shape), 0.1, **kw)
    for op in hier.operators:
        if isinstance(op, StencilOperator):
            _check_kernels(op, gen, dtype, exact=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(37, 45), (8, 8), (301, 7)])
def test_b13_matches_plain(device, dtype, shape):
    """The compressed 2D form (assembled, and random planes on every cell)
    and the stored radius-1 form (the stored DCA operator and random
    planes)."""
    gen = torch.Generator(device=device).manual_seed(shape[0])
    t = _tensor(shape, gen, device).double()
    ops = [compressed.assemble_compressed_dca(t, (1.0, 0.7), 0.1),
           compressed.CompressedDCAOperator(
               torch.randn((6, *shape), generator=gen, device=device,
                           dtype=torch.float64) + torch.tensor(
                   [0, 0, 0, 0, 0, 4.0], device=device, dtype=torch.float64).reshape(6, 1, 1),
               2),
           build_hierarchy(t, build_level_descriptors(shape), 0.1).operators[0],
           _random_op(shape, 1, gen, device)]
    for op in ops:
        _check_kernels(op, gen, dtype, exact=isinstance(op, StencilOperator))


def test_wrappers_refuse_what_their_kernel_does_not_take(device):
    gen = torch.Generator(device=device).manual_seed(0)
    op3 = _random_op((6, 7, 8), 2, gen, device)
    op2 = _random_op((6, 7), 1, gen, device)
    x3 = torch.zeros(op3.shape, device=device, dtype=torch.float64)
    x2 = torch.zeros(op2.shape, device=device, dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_smoothers.halfsweep(_random_op((6, 7, 8), 3, gen, device), x3, x3, 0)  # r = 3
    with pytest.raises(ValueError):
        cuda_smoothers.halfsweep(_random_op((6, 7), 2, gen, device), x2, x2, 0)  # 2D, r = 2
    with pytest.raises(ValueError):
        cuda_smoothers.cuda_residual_local(op2, x2, x2)  # 2D has no shard-local form
    with pytest.raises(TypeError):
        cuda_smoothers.cuda_residual(op3.astype(torch.float16), x3.half(), x3.half())
    with pytest.raises(ValueError):
        cuda_smoothers.halfsweep(op3, x3.transpose(0, 2).contiguous().transpose(0, 2), x3, 0)
    with pytest.raises(ValueError):
        cuda_smoothers.halfsweep(op2, x2, x2.cpu(), 0)


def test_b12_b13_check_refuses_what_the_grid_does_not_take(device):
    """Each refusal of the stored forms' ``_check``: more than 125 planes,
    shapes that differ from the operator's, and more rows than one launch's
    y grid takes (65535 blocks of 8 rows; 4 in float64)."""
    gen = torch.Generator(device=device).manual_seed(0)
    full = stencil_offsets(3, 2, drop_corners=False)
    op126 = StencilOperator(torch.ones((126, 2, 3, 4), device=device), full + ((0, 0, 1),))
    x3 = torch.zeros((2, 3, 4), device=device)
    with pytest.raises(ValueError, match="exceed 125"):
        cuda_smoothers.halfsweep(op126, x3, x3, 0)
    op3 = _random_op((2, 3, 4), 1, gen, device).astype(torch.float32)
    with pytest.raises(ValueError, match="!= operator"):
        cuda_smoothers.cuda_residual(op3, x3[:, :2].contiguous(), x3[:, :2].contiguous())
    for dtype, rows in ((torch.float32, 65535 * 8), (torch.float64, 65535 * 4)):
        tall = StencilOperator(torch.ones((19, 1, rows + 1, 1), device=device, dtype=dtype),
                               stencil_offsets(3, 1))
        xt = torch.zeros(tall.shape, device=device, dtype=dtype)
        with pytest.raises(ValueError, match="launch limit"):
            cuda_smoothers.halfsweep(tall, xt, xt, 0)
        with pytest.raises(ValueError, match="launch limit"):
            cuda_smoothers.halfsweep_local(tall, xt, xt, 0)
        tall2 = StencilOperator(tall.coeffs[:9, 0], stencil_offsets(2, 1))
        with pytest.raises(ValueError, match="launch limit"):
            cuda_smoothers.cuda_residual(tall2, xt[0], xt[0])
        # one row fewer fits: the kernels run
        ok = StencilOperator(tall.coeffs[:9, 0, 1:].contiguous(), stencil_offsets(2, 1))
        xo = torch.zeros(ok.shape, device=device, dtype=dtype)
        _check_bits(cuda_smoothers.cuda_residual(ok, xo, xo),
                    cuda_smoothers.residual_plain(ok, xo, xo))


def test_2d_transfers_on_cuda_take_the_plain_versions(device):
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((3, 40, 33), generator=gen, device=device)
    cent = ("c", "v")
    before = (cuda_transfer.cuda_restrict.launches, cuda_transfer.cuda_prolong.launches)
    for field in (x[0], x):
        got = transfer.restrict(field, cent, use_kernels=True)
        assert torch.equal(got, transfer.restrict_plain(field, cent))
        assert torch.equal(transfer.prolong(got, cent, use_kernels=True),
                           transfer.prolong_plain(got, cent))
    assert (cuda_transfer.cuda_restrict.launches,
            cuda_transfer.cuda_prolong.launches) == before


@pytest.mark.parametrize("shape,kw,used", [
    ((40, 36, 33), dict(coarse_operator="galerkin"),
     ("b17_sweep", "b12_halfsweep", "b12_residual", "b16")),
    ((40, 36, 33), dict(coarse_operator="galerkin", galerkin_variant="exact",
                        galerkin_prune_tol=1e-4),
     ("b17_sweep", "b12_halfsweep", "b12_residual", "b16")),
    ((40, 36, 33), dict(operator_repr="stored"), ("b12_halfsweep", "b12_residual")),
    ((200, 193), {}, ("b13_halfsweep", "b13_residual")),
    ((200, 193), dict(coarse_operator="galerkin"), ("b13_halfsweep", "b13_residual")),
], ids=["3d-collapsed", "3d-exact-pruned", "3d-stored", "2d-dca", "2d-collapsed"])
@pytest.mark.parametrize("mixed_precision", [False, True])
def test_solve_through_kernels_matches_plain(device, shape, kw, used, mixed_precision):
    """Each operator JAX sends to Pallas reaches its kernel (the counters
    move); the solve converges and agrees with the plain path."""
    gen = torch.Generator(device=device).manual_seed(0)
    t = _tensor(shape, gen, device)
    b = torch.rand(shape, generator=gen, device=device) * 255
    base = dict(time_step=0.1, tolerance=1e-6, max_cycles=50, **kw)
    cuda_smoothers.launches.clear()
    cuda_galerkin.cuda_galerkin_product.launches.clear()
    res = mad_diffusion(b, t, config=MADConfig.cuda(mixed_precision, **base), device=device)
    counts = {k: sum(cuda_smoothers.launches[key] for key in keys)
              for k, keys in STENCIL.items()}
    counts["b16"] = cuda_galerkin.cuda_galerkin_product.launches.total()
    assert all(counts[k] > 0 for k in used), counts
    ref = mad_diffusion(b, t, config=MADConfig.cuda(mixed_precision, use_kernels=False,
                                                    **base), device=device)
    for r in (res, ref):
        assert float(r.final_residual[0]) <= 1e-6 and int(r.num_cycles[0]) < 50
    assert abs(int(res.num_cycles[0]) - int(ref.num_cycles[0])) <= 1
    rel = ((res.output - ref.output).norm() / ref.output.norm()).item()
    assert rel <= 1e-4


def _centering(shape):
    return tuple(CELL if n % 2 == 0 else "v" for n in shape)


def _b16_fine_op(form, shape, gen, device):
    """A fine operator in float64: the compressed level-0 operator of a
    random tensor, or random planes on every cell (borders included) in the
    stored layouts: 19 (the stored DCA operator's), 27 (collapsed levels),
    125 (exact levels below the first)."""
    if form == "compressed":
        return compressed.assemble_compressed_dca(_tensor(shape, gen, device).double(),
                                                  (1.0, 0.9, 1.1), 0.1)
    if form == "stored117":
        return _random_op(shape, 2, gen, device, offsets=galerkin._structural_offsets(
            (CELL,) * 3, stencil_offsets(3), (2, 2, 2)))
    radius = 2 if form == "stored125" else 1
    return _random_op(shape, radius, gen, device, drop_corners=form == "stored19")


def _b16_form(form, shape, collapse):
    """The form B16 takes (``cuda_galerkin.FORMS``): on cell-centred axes
    the collapsed chain's fine operators onto 27 planes, and the exact
    chain's onto 117 or 125; any other operator or axis the generic form."""
    if any(n % 2 for n in shape):
        return "generic"
    if collapse:
        return {"compressed": "compressed19", "stored27": "stored27"}.get(form, "generic")
    return {"compressed": "exact19", "stored117": "exact117",
            "stored125": "exact125"}.get(form, "generic")


B16_CASES = [("compressed", (64, 64, 64)), ("compressed", (65, 65, 65)),
             ("compressed", (48, 40, 36)), ("compressed", (4, 33, 70)),
             ("stored19", (37, 41, 35)), ("stored27", (64, 64, 64)),
             ("stored27", (65, 18, 9)), ("stored125", (33, 36, 40)),
             ("compressed", (20, 46, 134)), ("stored117", (36, 42, 70)),
             ("stored125", (40, 38, 132)), ("stored125", (6, 4, 8))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("collapse", [True, False], ids=["collapsed", "exact"])
@pytest.mark.parametrize("form,shape", B16_CASES, ids=[f"{f}-{s}" for f, s in B16_CASES])
def test_b16_matches_the_eager_path(device, dtype, collapse, form, shape):
    """A compressed and stored fine operators (radius 1 and 2), both
    variants, cell and vertex axes, even, odd and non-cubic sizes, a coarse
    axis of 2, x and y past one tile and coarse sizes that are not whole
    tiles, every form (the exact chain's three with interior and border x
    tiles, y rows and z planes): the kernel's planes, offsets and dtype
    against the eager path in float64 on the same values, and its exact
    zeros."""
    gen = torch.Generator(device=device).manual_seed(len(shape) + shape[0])
    op = _b16_fine_op(form, shape, gen, device).astype(dtype)
    cent = _centering(shape)
    before = cuda_galerkin.cuda_galerkin_product.launches.copy()
    forms = cuda_galerkin.cuda_galerkin_product.forms.copy()
    got = galerkin.assemble_galerkin_parabolic(op, cent, collapse=collapse, use_kernels=True)
    torch.cuda.synchronize()
    variant = "collapsed" if collapse else "exact"
    assert cuda_galerkin.cuda_galerkin_product.launches - before == {variant: 1}
    assert (cuda_galerkin.cuda_galerkin_product.forms - forms
            == {_b16_form(form, shape, collapse): 1})
    want = galerkin.assemble_galerkin_parabolic(op.astype(torch.float64), cent,
                                                collapse=collapse)
    assert got.offsets == want.offsets and got.coeffs.dtype == dtype
    assert bool(torch.isfinite(got.coeffs).all())
    err = (got.coeffs.double() - want.coeffs).abs().max().item()
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert err <= tol * want.diag.abs().max().item()
    # a coupling that leaves the grid is an exact zero, as in the eager path
    # (bench_port/check_galerkin.py holds zero-scale coefficients to 0)
    assert bool((got.coeffs[want.coeffs == 0] == 0).all())


def test_b16_launches_once_per_galerkin_level(device):
    """One ``mad_diffusion`` call with Galerkin levels launches B16 once per
    coarse level, in float32 (``MADConfig.cuda``) and float64."""
    gen = torch.Generator(device=device).manual_seed(2)
    shape = (40, 36, 33)
    t = _tensor(shape, gen, device)
    b = torch.rand(shape, generator=gen, device=device) * 255
    n = len(build_level_descriptors(shape)) - 1
    for dtype in (torch.float32, torch.float64):
        before = cuda_galerkin.cuda_galerkin_product.launches.total()
        res = mad_diffusion(b, t, config=MADConfig.cuda(
            time_step=0.1, tolerance=1e-6, coarse_operator="galerkin"), dtype=dtype,
            device=device)
        assert cuda_galerkin.cuda_galerkin_product.launches.total() - before == n
        assert float(res.final_residual[0]) <= 1e-6


@pytest.mark.parametrize("variant,other", [("exact", "collapsed"), ("collapsed", "exact")])
def test_b16_counts_its_launches_by_variant(device, variant, other):
    """A 128^3 hierarchy counts each Galerkin level under its own variant
    and none under the other, and under its form: the exact chain's
    exact19, exact117, then exact125; the collapsed chain's compressed19,
    then stored27."""
    gen = torch.Generator(device=device).manual_seed(3)
    shape = (128,) * 3
    levels = build_level_descriptors(shape)
    before = cuda_galerkin.cuda_galerkin_product.launches.copy()
    forms = cuda_galerkin.cuda_galerkin_product.forms.copy()
    hier = build_hierarchy(_tensor(shape, gen, device), levels, 0.1, "galerkin", "compressed",
                           True, variant)
    torch.cuda.synchronize()
    got = cuda_galerkin.cuda_galerkin_product.launches - before
    assert got == {variant: len(levels) - 1} and got[other] == 0
    assert cuda_galerkin.cuda_galerkin_product.forms - forms == (
        {"exact19": 1, "exact117": 1, "exact125": len(levels) - 3} if variant == "exact"
        else {"compressed19": 1, "stored27": len(levels) - 2})
    planes = [len(op.offsets) for op in hier.operators[1:]]
    assert planes == ([117] + [125] * (len(levels) - 2) if variant == "exact"
                      else [27] * (len(levels) - 1))


@pytest.mark.parametrize("variant", ["collapsed", "exact"])
def test_b16_galerkin_levels_wait_for_nothing(device, monkeypatch, variant):
    """Once its plans are on the card, a 128^3 Galerkin ``build_hierarchy``
    builds its Galerkin levels (B16, the span ``madt.mad.setup.galerkin``),
    collapsed or exact, without a synchronising call:
    ``torch.cuda.set_sync_debug_mode('error')`` around each raises nothing.
    (The coarsest level's dense LU and its host check, outside that span,
    do wait.)"""
    gen = torch.Generator(device=device).manual_seed(4)
    shape = (128,) * 3
    t = _tensor(shape, gen, device)
    levels = build_level_descriptors(shape)
    build_hierarchy(t, levels, 0.1, "galerkin", "compressed", True, variant)
    torch.cuda.synchronize()
    real = mad.assemble_galerkin_parabolic

    def strict(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(mad, "assemble_galerkin_parabolic", strict)
    before = cuda_galerkin.cuda_galerkin_product.launches.total()
    build_hierarchy(t, levels, 0.1, "galerkin", "compressed", True, variant)
    torch.cuda.synchronize()
    assert cuda_galerkin.cuda_galerkin_product.launches.total() - before == len(levels) - 1


def test_b16_refuses_2d_and_bfloat16(device):
    """The wrapper refuses a 2D operator and bfloat16 planes; the routing
    leaves them (and float16) to the eager path."""
    gen = torch.Generator(device=device).manual_seed(6)
    op2 = _random_op((12, 10), 1, gen, device)
    with pytest.raises(ValueError):
        cuda_galerkin.cuda_galerkin_product(op2, (CELL, CELL), True)
    op3 = _b16_fine_op("compressed", (16, 16, 16), gen, device)
    for dtype in (torch.bfloat16, torch.float16):
        with pytest.raises(TypeError):
            cuda_galerkin.cuda_galerkin_product(op3.astype(dtype), (CELL,) * 3, True)
        assert not cuda_galerkin.kernel_takes(op3.astype(dtype))
    assert not cuda_galerkin.kernel_takes(op2)
    before = cuda_galerkin.cuda_galerkin_product.launches.total()
    got = galerkin.assemble_galerkin_parabolic(op3.astype(torch.bfloat16), (CELL,) * 3,
                                               collapse=True, use_kernels=True)
    assert got.coeffs.dtype == torch.bfloat16
    assert cuda_galerkin.cuda_galerkin_product.launches.total() == before
