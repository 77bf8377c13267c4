"""The stored-operator and 2D stencil kernels (B12, B13) against their plain
PyTorch versions on the card, and the Galerkin and 2D solves through them.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one;
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_galerkin.py``
runs them on a machine with a card.  The random operators carry nonzero
coefficients on the offsets that leave the grid: the kernels must skip those
terms as the plain versions' zero padding does.  Tolerances as in
``tests/test_torch_cuda.py``: float64 1e-12 and float32 1e-5 of the largest
reference value, bf16 one bf16 ulp of each value with the float32 floor.
"""

import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.core.stencil import StencilOperator, stencil_offsets
from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
from multigridanisotropicdiffusion_tpu_torch.ops import (
    compressed,
    cuda_smoothers,
    cuda_stencil2d,
    cuda_stencil_stored,
    cuda_transfer,
    transfer,
)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float64, torch.float32, torch.bfloat16]
COUNTERS = {
    "b1_halfsweep": cuda_smoothers.halfsweep,
    "b12_halfsweep": cuda_stencil_stored.halfsweep,
    "b12_residual": cuda_stencil_stored.cuda_residual,
    "b13_halfsweep": cuda_stencil2d.halfsweep,
    "b13_residual": cuda_stencil2d.cuda_residual,
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


def _random_op(shape, radius, gen, device, drop_corners=False):
    """Random planes everywhere, borders included; a dominant diagonal."""
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


def _check_kernels(module, op, gen, dtype):
    op = op.astype(dtype)
    x = (torch.randn(op.shape, generator=gen, device="cuda", dtype=torch.float64) * 10).to(dtype)
    b = (torch.randn(op.shape, generator=gen, device="cuda", dtype=torch.float64) * 10).to(dtype)
    for color in (0, 1):
        _check(module.halfsweep(op, x, b, color), module.halfsweep_plain(op, x, b, color))
    _check(module.cuda_residual(op, x, b), module.residual_plain(op, x, b))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("radius,drop_corners,shape", [
    (1, True, (9, 13, 35)), (1, False, (7, 10, 33)), (2, False, (6, 11, 37)),
    (2, False, (3, 4, 5)),
], ids=["19", "27", "125", "125-tiny"])
def test_b12_random_operators_match_plain(device, dtype, radius, drop_corners, shape):
    gen = torch.Generator(device=device).manual_seed(radius + len(shape))
    _check_kernels(cuda_stencil_stored, _random_op(shape, radius, gen, device, drop_corners),
                   gen, dtype)


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
            _check_kernels(cuda_stencil_stored, op, gen, dtype)


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
        _check_kernels(cuda_stencil2d, op, gen, dtype)


def test_wrappers_refuse_what_their_kernel_does_not_take(device):
    gen = torch.Generator(device=device).manual_seed(0)
    op3 = _random_op((6, 7, 8), 2, gen, device)
    op2 = _random_op((6, 7), 1, gen, device)
    x3 = torch.zeros(op3.shape, device=device, dtype=torch.float64)
    x2 = torch.zeros(op2.shape, device=device, dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_stencil_stored.halfsweep(op2, x2, x2, 0)  # 2D
    with pytest.raises(ValueError):
        cuda_stencil2d.halfsweep(_random_op((6, 7), 2, gen, device), x2, x2, 0)  # r = 2
    with pytest.raises(ValueError):
        cuda_stencil2d.cuda_residual(op3, x3, x3)  # 3D
    with pytest.raises(TypeError):
        cuda_stencil_stored.cuda_residual(op3.astype(torch.float16), x3.half(), x3.half())
    with pytest.raises(ValueError):
        cuda_stencil_stored.halfsweep(op3, x3.transpose(0, 2).contiguous().transpose(0, 2),
                                      x3, 0)
    with pytest.raises(ValueError):
        cuda_stencil2d.halfsweep(op2, x2, x2.cpu(), 0)


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
     ("b1_halfsweep", "b12_halfsweep", "b12_residual")),
    ((40, 36, 33), dict(coarse_operator="galerkin", galerkin_variant="exact",
                        galerkin_prune_tol=1e-4),
     ("b1_halfsweep", "b12_halfsweep", "b12_residual")),
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
    for f in COUNTERS.values():
        f.launches = 0
    res = mad_diffusion(b, t, config=MADConfig.cuda(mixed_precision, **base), device=device)
    counts = {k: f.launches for k, f in COUNTERS.items()}
    assert all(counts[k] > 0 for k in used), counts
    ref = mad_diffusion(b, t, config=MADConfig.cuda(mixed_precision, use_kernels=False,
                                                    **base), device=device)
    for r in (res, ref):
        assert float(r.final_residual[0]) <= 1e-6 and int(r.num_cycles[0]) < 50
    assert abs(int(res.num_cycles[0]) - int(ref.num_cycles[0])) <= 1
    rel = ((res.output - ref.output).norm() / ref.output.norm()).item()
    assert rel <= 1e-4
