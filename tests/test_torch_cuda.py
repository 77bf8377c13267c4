"""The CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one;
``python -m pytest -m cuda tests/test_torch_cuda.py`` runs them on a machine
with a card.  They mirror the kernel phase of ``chip_smoke.py`` at the
(69, 77, 69) hierarchy's levels (vertex centring) and a small all-cell
pair.  The stencil kernels (B1/B2, and B17, the fused red-black sweep) and
the restriction round as their plain versions do: the half-sweeps, the
sweep and the residual are held to the plain versions' bytes in every
dtype, also on ragged shapes (rows that are not whole 4-cell vectors, fewer
rows than a tile, one or two planes), the restriction to ``torch.equal``;
a whole solve through B17 equals the one through two half-sweeps a sweep.  Tolerances elsewhere: float64 1e-12 and
float32 1e-5 of the largest reference value (the kernels sum in another
order than the plain versions); bf16 one bf16 ulp of each reference value
(both compute in float32 and round once), with the float32 floor for values
near zero.
"""

import itertools

import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_assemble, cuda_smoothers
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_transfer, transfer
from multigridanisotropicdiffusion_tpu_torch.ops.compressed import (
    CompressedDCAOperator,
    assemble_compressed_dca,
)

pytestmark = pytest.mark.cuda

LEVELS = build_level_descriptors((69, 77, 69)) + build_level_descriptors((32, 32, 32))
DTYPES = [torch.float64, torch.float32, torch.bfloat16]
#: shapes that are not whole tiles: X not a multiple of 4, X < 128, Y below
#: a tile's rows, Z = 1 and 2
RAGGED = [(1, 5, 3), (2, 9, 130), (3, 7, 127), (5, 17, 4), (2, 3, 133), (9, 10, 64)]
INTS = {2: torch.int16, 4: torch.int32, 8: torch.int64}
#: the B1/B2 keys of ``cuda_smoothers.launches``, B17's, and the other
#: kernels' wrappers, which count on ``.launches``
HALF = (("compressed", "halfsweep"), ("compressed", "residual"))
SWEEP = ("compressed", "sweep")
#: the fused sweep's shapes beside RAGGED: a run boundary (17 and 20 planes
#: in runs of 8) and tile boundaries in y (9, 17 rows) and x (130, 257
#: columns), rows that are not whole vectors, a single plane, fewer planes
#: than a run, and the coarsest DCA levels
SWEEP_SHAPES = [(17, 9, 130), (20, 17, 257), (9, 10, 67), (1, 20, 140), (5, 17, 260),
                (8, 8, 8), (16, 16, 16), (33, 70, 260)]
COUNTERS = (cuda_transfer.cuda_restrict, cuda_transfer.cuda_prolong,
            cuda_assemble.cuda_assemble_compressed_dca)


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
    if want.dtype == torch.bfloat16:
        a = w.abs().clamp_min(torch.finfo(torch.float32).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
        assert bool((err <= torch.maximum(ulp, torch.full_like(ulp, 1e-5 * scale))).all())
    else:
        tol = 1e-12 if want.dtype == torch.float64 else 1e-5
        assert err.max().item() <= tol * scale


def _check_bits(got, want):
    """The kernel's output is the plain version's bytes (signed zeros
    included)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    ints = INTS[got.element_size()]
    assert torch.equal(got.contiguous().view(ints), want.contiguous().view(ints))


def _tensor(shape, device, gen):
    g = torch.randn((3, 3, *shape), generator=gen, device=device)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    t = torch.stack([(g[i] * g[j]).sum(0) + (2.0 if i == j else 0.0) for i, j in pairs])
    return t


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("level", range(len(LEVELS)))
def test_kernels_match_plain(device, level, dtype):
    lvl = LEVELS[level]
    gen = torch.Generator(device=device).manual_seed(level)
    # the assembly kernel runs in the solve precision (f32/f64) only
    t = _tensor(lvl.shape, device, gen).to(
        torch.float32 if dtype == torch.bfloat16 else dtype)
    plain = assemble_compressed_dca(t, lvl.spacing, 0.1)
    if dtype != torch.bfloat16:
        got = cuda_assemble.cuda_assemble_compressed_dca(t, lvl.spacing, 0.1)
        _check(got.planes, plain.planes)
    op = plain.astype(dtype)
    x = torch.randn(lvl.shape, generator=gen, device=device).to(dtype) * 10
    b = torch.randn(lvl.shape, generator=gen, device=device).to(dtype) * 10
    for color in (0, 1):
        _check_bits(cuda_smoothers.halfsweep(op, x, b, color),
                    cuda_smoothers.halfsweep_plain(op, x, b, color))
    _check_bits(cuda_smoothers.cuda_residual(op, x, b),
                cuda_smoothers.residual_plain(op, x, b))
    if level + 1 < len(LEVELS) and LEVELS[level + 1].index == lvl.index + 1:
        cent = LEVELS[level + 1].centering
        assert torch.equal(cuda_transfer.cuda_restrict(x, cent),
                           transfer.restrict_plain(x, cent))
        batch = t.to(dtype)
        assert torch.equal(cuda_transfer.cuda_restrict(batch, cent),
                           transfer.restrict_plain(batch, cent))
        e = transfer.restrict_plain(x, cent)
        _check(cuda_transfer.cuda_prolong(e, cent), transfer.prolong_plain(e, cent))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", RAGGED, ids=str)
def test_stencil_ragged_shapes_bit_for_bit(device, shape, dtype):
    """B1/B2 on shapes that are not whole tiles, on random planes non-zero
    on every border (the zero-staged ring, not the operator's folding, keeps
    the border terms), and with an ``x`` that is not 16-byte aligned (the
    scalar loads): the plain versions' bytes, one launch each."""
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    planes = torch.randn((10, *shape), generator=gen, device=device, dtype=torch.float64)
    planes[-1] = 8.0 + planes[-1].abs()
    op = CompressedDCAOperator(planes.to(dtype), 3)
    x = (torch.randn(shape, generator=gen, device=device, dtype=torch.float64) * 10).to(dtype)
    b = (torch.randn(shape, generator=gen, device=device, dtype=torch.float64) * 10).to(dtype)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=device)
    shifted = flat[1:].view(shape)
    shifted.copy_(x)
    before = cuda_smoothers.launches.copy()
    for xin in (x, shifted):
        for color in (0, 1):
            _check_bits(cuda_smoothers.halfsweep(op, xin, b, color),
                        cuda_smoothers.halfsweep_plain(op, x, b, color))
        _check_bits(cuda_smoothers.cuda_residual(op, xin, b),
                    cuda_smoothers.residual_plain(op, x, b))
    torch.cuda.synchronize()
    assert cuda_smoothers.launches - before == dict(zip(HALF, (4, 2)))


def _random_compressed(shape, dtype, device, gen):
    """Random planes on every cell, the mixed ones too (so that the sweep's
    same-colour coupling matters), a dominant diagonal; x and b."""
    planes = torch.randn((10, *shape), generator=gen, device=device, dtype=torch.float64)
    planes[-1] = 8.0 + planes[-1].abs()
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float64) * 10.0
    b = torch.randn(shape, generator=gen, device=device, dtype=torch.float64) * 10.0
    return CompressedDCAOperator(planes.to(dtype), 3), x.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SWEEP_SHAPES + RAGGED, ids=str)
def test_fused_sweep_bit_for_bit(device, shape, dtype):
    """B17: ``rbgs_sweep`` on the compressed operator is one launch, and its
    output is the bytes of ``rbgs_sweep_plain`` and of the two half-sweep
    launches, with x aligned and not (the scalar loads)."""
    gen = torch.Generator(device=device).manual_seed(7 * sum(shape))
    op, x, b = _random_compressed(shape, dtype, device, gen)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=device)
    shifted = flat[1:].view(shape)
    shifted.copy_(x)
    want = cuda_smoothers.rbgs_sweep_plain(op, x, b)
    for xin in (x, shifted):
        before = cuda_smoothers.launches.copy()
        got = cuda_smoothers.rbgs_sweep(op, xin, b)
        torch.cuda.synchronize()
        assert cuda_smoothers.launches - before == {SWEEP: 1}
        _check_bits(got, want)
        pair = cuda_smoothers.halfsweep(op, cuda_smoothers.halfsweep(op, xin, b, 0), b, 1)
        _check_bits(got, pair)


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_solve_with_fused_sweeps_equals_the_two_launch_path(device, monkeypatch,
                                                            mixed_precision):
    """A whole ``mad_diffusion`` call through B17 against the same call with
    every sweep as two half-sweep launches: the same output bits, cycles and
    residual histories; the first launches no compressed half-sweep."""
    gen = torch.Generator(device=device).manual_seed(3)
    shape = (40, 36, 33)
    t = _tensor(shape, device, gen)
    b = torch.rand(shape, generator=gen, device=device) * 255
    cfg = MADConfig.cuda(mixed_precision, time_step=0.1, tolerance=1e-6, max_cycles=50)
    cuda_smoothers.launches.clear()
    res = mad_diffusion(b, t, config=cfg, device=device)
    fused = cuda_smoothers.launches.copy()
    assert fused[SWEEP] > 0 and fused["compressed", "halfsweep"] == 0

    def two_launches(op, x, rhs):
        return cuda_smoothers.halfsweep(op, cuda_smoothers.halfsweep(op, x, rhs, 0), rhs, 1)

    monkeypatch.setattr(cuda_smoothers, "rbgs_sweep", two_launches)
    cuda_smoothers.launches.clear()
    ref = mad_diffusion(b, t, config=cfg, device=device)
    assert cuda_smoothers.launches["compressed", "halfsweep"] == 2 * fused[SWEEP]
    assert cuda_smoothers.launches[SWEEP] == 0
    assert torch.equal(res.num_cycles, ref.num_cycles)
    _check_bits(res.residual_history, ref.residual_history)
    _check_bits(res.final_residual, ref.final_residual)
    _check_bits(res.output, ref.output)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("cent", list(itertools.product("cv", repeat=3)), ids="".join)
def test_prolong_every_centring_mix(device, cent, dtype):
    """B4 on each per-axis centring mix, on odd coarse shapes (partial
    16-byte rows) and on rows of whole 16-byte vectors, several blocks of
    fine planes, with and without a batch of 6: ``P e`` within the bounds
    above of the plain version; the add form bit for bit ``x +
    cuda_prolong(e)``, also with an ``x`` that is not 16-byte aligned."""
    gen = torch.Generator(device=device).manual_seed(sum(c == "c" for c in cent))
    for coarse, lead in (((5, 7, 9), ()), ((17, 5, 16), ()), ((5, 7, 9), (6,)),
                         ((17, 5, 16), (6,))):
        fine = tuple(transfer.fine_size(n, c) for n, c in zip(coarse, cent))
        e = torch.randn((*lead, *coarse), generator=gen, device=device,
                        dtype=torch.float64).to(dtype)
        x = torch.randn((*lead, *fine), generator=gen, device=device,
                        dtype=torch.float64).to(dtype)
        before = cuda_transfer.cuda_prolong.launches
        p = cuda_transfer.cuda_prolong(e, cent)
        _check(p, transfer.prolong_plain(e, cent))
        got = cuda_transfer.cuda_prolong_add(x, e, cent)
        assert got.dtype == dtype and torch.equal(got, x + p)
        _check(got, transfer.prolong_add_plain(x, e, cent))
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        shifted = flat[1:].view(x.shape)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 != 0
        assert torch.equal(cuda_transfer.cuda_prolong_add(shifted, e, cent), x + p)
        torch.cuda.synchronize()
        assert cuda_transfer.cuda_prolong.launches - before == 3


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("cent", list(itertools.product("cv", repeat=3)), ids="".join)
def test_restrict_every_centring_mix_bit_for_bit(device, cent, dtype):
    """B3 on each per-axis centring mix: odd and even fine shapes, coarse x
    a multiple of the 16-byte run (4 f32, 8 bf16, 2 f64) and not, tiles cut
    unevenly in y and x, several runs of coarse planes, with and without a
    batch of 6: ``torch.equal`` to ``restrict_plain``."""
    gen = torch.Generator(device=device).manual_seed(sum(c == "c" for c in cent))
    for coarse, lead in (((5, 7, 9), ()), ((17, 5, 16), ()), ((5, 7, 9), (6,)),
                         ((9, 19, 67), ()), ((20, 33, 130), (6,)), ((2, 3, 2), ())):
        fine = tuple(transfer.fine_size(n, c) for n, c in zip(coarse, cent))
        x = torch.randn((*lead, *fine), generator=gen, device=device,
                        dtype=torch.float64).to(dtype)
        before = cuda_transfer.cuda_restrict.launches
        got = cuda_transfer.cuda_restrict(x, cent)
        want = transfer.restrict_plain(x, cent)
        assert got.shape == (*lead, *coarse) and got.dtype == dtype
        assert torch.equal(got, want)
        torch.cuda.synchronize()
        assert cuda_transfer.cuda_restrict.launches - before == 1


def test_kernel_wrappers_refuse_bad_input(device):
    op = assemble_compressed_dca(torch.ones((6, 8, 8, 8), device=device), (1.0,) * 3, 0.1)
    x = torch.ones((8, 8, 8), device=device)
    with pytest.raises(TypeError):
        cuda_smoothers.halfsweep(op, x.half(), x.half(), 0)
    with pytest.raises(ValueError):
        cuda_smoothers.halfsweep(op, x.transpose(0, 2), x, 0)
    with pytest.raises(ValueError):
        cuda_transfer.cuda_restrict(torch.ones((8, 8), device=device), ("c", "c"))
    with pytest.raises(ValueError):
        cuda_transfer.cuda_prolong_add(x, torch.ones((4, 4, 5), device=device), ("c",) * 3)
    with pytest.raises(ValueError):
        cuda_transfer.cuda_prolong_add(x.cpu(), torch.ones((4, 4, 4), device=device),
                                       ("c",) * 3)
    with pytest.raises(TypeError, match="GridMesh"):
        mad_diffusion(torch.ones((16, 16), device=device), torch.ones((3, 16, 16)),
                      config=MADConfig.cuda(), device=device, mesh=object())


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_solve_through_kernels_matches_plain(device, mixed_precision):
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (40, 36, 33)
    t = _tensor(shape, device, gen)
    b = torch.rand(shape, generator=gen, device=device) * 255
    cfg = MADConfig.cuda(mixed_precision, time_step=0.1, tolerance=1e-6, max_cycles=50)
    cuda_smoothers.launches.clear()
    for f in COUNTERS:
        f.launches = 0
    res = mad_diffusion(b, t, config=cfg, device=device)
    assert all(f.launches > 0 for f in COUNTERS)
    assert all(cuda_smoothers.launches[k] > 0 for k in (SWEEP, HALF[1]))
    assert cuda_smoothers.launches[HALF[0]] == 0
    ref = mad_diffusion(b, t, config=MADConfig.cuda(
        mixed_precision, use_kernels=False, time_step=0.1, tolerance=1e-6,
        max_cycles=50), device=device)
    for r in (res, ref):
        assert float(r.final_residual[0]) <= 1e-6 and int(r.num_cycles[0]) < 50
    rel = ((res.output - ref.output).norm() / ref.output.norm()).item()
    assert rel <= 1e-4
