"""The shard-local kernel B14 against its plain versions on the card, and
the distributed kernel path with two ranks on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one;
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_halo.py`` runs
them on a machine with a card.  The planes are random and non-zero on every
border, so the masking matters at every block face.  Both forms round as
their plain versions do and are held to them with ``torch.equal`` (values
equal, the sign of an exact zero aside: the stored form's plain version
masks a coefficient to 0 where the kernel multiplies by a zero halo), the
compressed form also on shapes that are not whole tiles.  Tolerances
elsewhere as in ``tests/test_torch_cuda.py``: float64 1e-12 and float32
1e-5 of the largest reference value, bf16 one bf16 ulp of each value with
the float32 floor.
The two-rank tests: gloo ranks sharing cuda:0 (faces staged through the
host), and NCCL ranks on two cards where there are two; the overlapped
kernel path must give the blocking order's bits.
"""

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch.core.stencil import StencilOperator, stencil_offsets
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers, cuda_transfer, transfer
from multigridanisotropicdiffusion_tpu_torch.ops.compressed import CompressedDCAOperator
from multigridanisotropicdiffusion_tpu_torch.parallel.transfer import PROLONG, RESTRICT, _axis_plan

from .torch_dist_workers import cuda_worker, run_ranks

pytestmark = pytest.mark.cuda

DTYPES = [torch.float64, torch.float32, torch.bfloat16]
SHAPES = [(37, 45, 51), (16, 24, 16), (1, 5, 3)]
#: more shapes that are not whole tiles (X not a multiple of 4, X < 128, Y
#: below a tile's rows, Z = 2)
RAGGED = [(2, 9, 130), (3, 7, 127), (5, 17, 4), (2, 3, 133)]


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


def _inputs(shape, device, dtype, k):
    gen = torch.Generator(device=device).manual_seed(0)
    planes = torch.randn((k, *shape), generator=gen, device=device, dtype=torch.float64)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    b = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    return planes, x.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + RAGGED)
def test_b14_compressed_matches_plain(device, shape, dtype):
    planes, x, b = _inputs(shape, device, dtype, 10)
    planes[-1] = 8.0 + planes[-1].abs()
    op = CompressedDCAOperator(planes.to(dtype), 3)
    before = cuda_smoothers.launches.copy()
    for color in (0, 1):
        assert torch.equal(cuda_smoothers.halfsweep_local(op, x, b, color),
                           cuda_smoothers.halfsweep_local_plain(op, x, b, color))
    assert torch.equal(cuda_smoothers.cuda_residual_local(op, x, b),
                       cuda_smoothers.residual_local_plain(op, x, b))
    torch.cuda.synchronize()
    assert cuda_smoothers.launches - before == {("compressed", "halfsweep_local"): 2,
                                                ("compressed", "residual_local"): 1}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_b14_stored_through_b12_matches_plain(device, shape, dtype):
    offsets = stencil_offsets(3, 1, drop_corners=False)
    planes, x, b = _inputs(shape, device, dtype, len(offsets))
    c = offsets.index((0, 0, 0))
    planes[c] = 30.0 + planes[c].abs()
    op = StencilOperator(planes.to(dtype), offsets)
    before = cuda_smoothers.launches.copy()
    for color in (0, 1):
        assert torch.equal(cuda_smoothers.halfsweep_local(op, x, b, color),
                           cuda_smoothers.halfsweep_local_plain(op, x, b, color))
    assert torch.equal(cuda_smoothers.cuda_residual_local(op, x, b),
                       cuda_smoothers.residual_local_plain(op, x, b))
    torch.cuda.synchronize()
    assert cuda_smoothers.launches - before == {("stored", "halfsweep_local"): 2,
                                                ("stored", "residual_local"): 1}


def test_b14_wrappers_refuse_what_the_kernel_does_not_take(device):
    planes, x, b = _inputs((4, 5, 6), device, torch.float32, 10)
    op = CompressedDCAOperator(planes.float(), 3)
    with pytest.raises(ValueError):
        cuda_smoothers.halfsweep_local(op, x[:, :4], b, 0)
    offsets = stencil_offsets(3, 2, drop_corners=False)
    op2 = StencilOperator(torch.zeros((len(offsets), 4, 5, 6), device=device), offsets)
    with pytest.raises(ValueError):
        cuda_smoothers.halfsweep_local(op2, x, b, 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cent", [("c", "c", "c"), ("v", "c", "v")])
def test_prolong_block_matches_plain(device, cent, dtype):
    """B4 on the blocks of a prolongation split along z on two ranks
    (``parallel/transfer.py``'s plans: starts shifted into the halo-extended
    block; the vertex axis padded 33 -> 34 with a pad row of weight 0)
    against the plain version of the block form."""
    fine = (33 if cent[0] == "v" else 32, 16, 17 if cent[2] == "v" else 18)
    coarse = tuple(transfer.coarse_size(n, c) for n, c in zip(fine, cent))
    padded = (-(-fine[0] // 2) * 2, -(-coarse[0] // 2) * 2)
    gen = torch.Generator(device=device).manual_seed(0)
    for rank in (0, 1):
        plans = [_axis_plan(PROLONG, fine[0], cent[0], padded[1], padded[0], True, True,
                            2, rank)]
        plans += [_axis_plan(PROLONG, fine[d], cent[d], coarse[d], fine[d], False, False,
                             1, 0) for d in (1, 2)]
        ext = (padded[1] // 2 + sum(plans[0].recv), coarse[1], coarse[2])
        tables = tuple((ax.start, ax.weights) for ax in plans)
        block = torch.randn(ext, generator=gen, device=device,
                            dtype=torch.float64).to(dtype)
        before = cuda_transfer.cuda_prolong.launches
        got = cuda_transfer.prolong_block(
            block, cuda_transfer.BlockTables(tables, 2, dtype, block.device))
        _check(got, transfer.apply_taps_plain(block, tables, (2, 1, 0)))
        torch.cuda.synchronize()
        assert got.shape == (padded[0] // 2, fine[1], fine[2])
        assert cuda_transfer.cuda_prolong.launches - before == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cent", [("c", "c", "c"), ("v", "c", "v"), ("c", "v", "c")])
@pytest.mark.parametrize("split", [0, 1, 2, None])
def test_restrict_block_matches_plain_bit_for_bit(device, cent, split, dtype):
    """B3 on the blocks of a restriction split along one axis on two ranks
    (``parallel/transfer.py``'s plans: starts shifted into the block
    extended by the neighbour's rows; a vertex axis padded 17 -> 18 with a
    pad row of weight 0 that starts at 0, which in y or x sends the block
    to the kernel's per-output form) and on an unsplit level, equal to the
    plain version of the block form, ``apply_taps_plain`` over axes (0, 1,
    2)."""
    fine = (33 if cent[0] == "v" else 32, 35 if cent[1] == "v" else 16,
            33 if cent[2] == "v" else 18)
    coarse = tuple(transfer.coarse_size(n, c) for n, c in zip(fine, cent))
    gen = torch.Generator(device=device).manual_seed(0)
    for rank in ((0, 1) if split is not None else (0,)):
        plans, ext, out = [], [], []
        for d in range(3):
            if d == split:
                f, c = -(-fine[d] // 2) * 2, -(-coarse[d] // 2) * 2
                ax = _axis_plan(RESTRICT, fine[d], cent[d], f, c, True, True, 2, rank)
                ext.append(f // 2 + sum(ax.recv))
                out.append(c // 2)
            else:
                ax = _axis_plan(RESTRICT, fine[d], cent[d], fine[d], coarse[d], False,
                                False, 1, 0)
                ext.append(fine[d])
                out.append(coarse[d])
            plans.append(ax)
        tables = tuple((ax.start, ax.weights) for ax in plans)
        block = torch.randn(ext, generator=gen, device=device,
                            dtype=torch.float64).to(dtype)
        before = cuda_transfer.cuda_restrict.launches
        got = cuda_transfer.restrict_block(
            block, cuda_transfer.BlockTables(tables, 4, dtype, block.device))
        want = transfer.apply_taps_plain(block, tables, (0, 1, 2))
        assert got.shape == tuple(out)
        assert torch.equal(got, want)
        torch.cuda.synchronize()
        assert cuda_transfer.cuda_restrict.launches - before == 1


def _two_ranks(tmp_path, backend):
    run_ranks(cuda_worker, 2, tmp_path, str(tmp_path / "out.npz"), backend, timeout=110)
    return dict(np.load(tmp_path / "out.npz"))


def _check_two_ranks(r):
    for name in ("sweep", "residual"):
        # the overlapped schedule (faces on a side stream beside B14) gives
        # the blocking order's bits
        assert np.array_equal(r[name], r[f"{name}_blocking"])
        scale = np.abs(r[f"{name}_ref"]).max()
        assert np.abs(r[name] - r[f"{name}_ref"]).max() <= 1e-5 * scale
    assert (r["launches"] > 0).all()
    assert abs(int(r["cycles"][0]) - int(r["cycles_ref"][0])) <= 1
    rel = np.linalg.norm(r["solve"] - r["solve_ref"]) / np.linalg.norm(r["solve_ref"])
    assert rel <= 1e-4


def test_distributed_kernel_path_gloo_ranks_share_one_card(device, tmp_path):
    _check_two_ranks(_two_ranks(tmp_path, "gloo"))


def test_distributed_kernel_path_nccl_two_cards(device, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _check_two_ranks(_two_ranks(tmp_path, "nccl"))
