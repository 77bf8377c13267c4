"""Port parity, transfers: restriction and prolongation against the JAX
package's ``ops.transfer`` on every level of a (69, 77, 69) hierarchy (the
vertex-centred chain), an all-cell 32^3 pair and 2D; the transfer kernels'
tap tables against the JAX package's 1-D matrices; the tables applied z,
then y, then x (the restriction kernel's order) equal to the plain
restriction; the prolongation's add form ``x + P e``; and the library calls that compute the all-cell
transfers (``chip_smoke.py``'s yardsticks)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.ops import galerkin_direct as jgd
from multigridanisotropicdiffusion_tpu.ops import transfer as jtransfer
from multigridanisotropicdiffusion_tpu_torch.core.grids import (
    CELL,
    VERTEX,
    build_level_descriptors,
)
from multigridanisotropicdiffusion_tpu_torch.ops import transfer
from multigridanisotropicdiffusion_tpu_torch.ops.cuda_transfer import (
    cuda_prolong,
    cuda_prolong_add,
    cuda_restrict,
)

VED_LEVELS = build_level_descriptors((69, 77, 69))
CELL_LEVELS = build_level_descriptors((32, 32, 32))
PAIRS = (
    [(VED_LEVELS, i) for i in range(1, len(VED_LEVELS))]
    + [(CELL_LEVELS, 1), (build_level_descriptors((17, 16)), 1)]
)
IDS = [f"{lv[i - 1].shape}->{lv[i].shape}" for lv, i in PAIRS]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("levels,i", PAIRS, ids=IDS)
def test_restrict_and_prolong_match_jax(levels, i):
    fine, coarse = levels[i - 1].shape, levels[i].shape
    cent = levels[i].centering
    rng = np.random.default_rng(i)
    u = rng.normal(size=fine)
    e = rng.normal(size=coarse)

    got = transfer.restrict(torch.as_tensor(u), cent)
    assert tuple(got.shape) == coarse
    assert _rel(got, jtransfer.restrict(jnp.asarray(u), cent)) <= 1e-13
    got = transfer.prolong(torch.as_tensor(e), cent)
    assert tuple(got.shape) == fine
    assert _rel(got, jtransfer.prolong(jnp.asarray(e), cent)) <= 1e-13
    # the kernel wrappers take the same plain path for a CPU tensor
    if len(fine) == 3:
        before = (cuda_restrict.launches, cuda_prolong.launches)
        assert torch.equal(cuda_restrict(torch.as_tensor(u), cent),
                           transfer.restrict_plain(torch.as_tensor(u), cent))
        assert torch.equal(cuda_prolong(torch.as_tensor(e), cent),
                           transfer.prolong_plain(torch.as_tensor(e), cent))
        assert (cuda_restrict.launches, cuda_prolong.launches) == before


def test_restrict_tensor_matches_jax():
    lv = VED_LEVELS
    rng = np.random.default_rng(7)
    planes = rng.normal(size=(6, *lv[0].shape))
    got = transfer.restrict_tensor(torch.as_tensor(planes), lv[1].centering,
                                   use_kernels=True)
    want = jtransfer.restrict_tensor(tuple(jnp.asarray(p) for p in planes),
                                     lv[1].centering)
    assert got.shape == (6, *lv[1].shape)
    for k in range(6):
        assert _rel(got[k], want[k]) <= 1e-13


@pytest.mark.parametrize("n", [6, 7, 9, 16, 18, 35, 69, 77, 512])
def test_tap_tables_match_jax_matrices(n):
    cents = (VERTEX,) if n % 2 else (VERTEX, CELL)
    for cent in cents:
        for taps, matrix, width in (
            (transfer.restrict_taps, jgd.restrict_matrix_1d, 4),
            (transfer.prolong_taps, jgd.prolong_matrix_1d, 2),
        ):
            start, w = taps(n, cent)
            want = np.asarray(matrix(n, cent))
            dense = np.zeros_like(want)
            for row, s in enumerate(start):
                for t in range(width):
                    if w[row, t]:
                        dense[row, s + t] = w[row, t]
            np.testing.assert_array_equal(dense, want)
            np.testing.assert_array_equal(
                transfer.restrict_matrix_1d(n, cent) if width == 4
                else transfer.prolong_matrix_1d(n, cent), want)


def test_bf16_plain_transfers_round_once():
    """16-bit storage computes in float32 and rounds once, as the kernels do."""
    lv = VED_LEVELS
    u = torch.as_tensor(np.random.default_rng(8).normal(size=lv[0].shape),
                        dtype=torch.bfloat16)
    assert torch.equal(
        transfer.restrict_plain(u, lv[1].centering),
        transfer.restrict_plain(u.float(), lv[1].centering).bfloat16(),
    )


@pytest.mark.parametrize("coarse", [(4, 6, 8), (5, 7, 3), (3, 5, 9)])
def test_library_forms_are_the_all_cell_transfers(coarse):
    """The yardsticks ``chip_smoke.py`` times beside B3 and B4 compute their
    functions on all-cell levels: trilinear ``F.interpolate`` (its clamped
    source coordinate gives the border row (1)) is ``prolong_plain``, and
    replicate padding plus a stride-2 ``F.conv3d`` with the ``[1, 3, 3,
    1] / 8`` product kernel (the replicated plane makes the border row [1/2
    3/8 1/8]) is ``restrict_plain``, on even and odd coarse sizes."""
    import torch.nn.functional as F

    cent = (CELL,) * 3
    rng = np.random.default_rng(sum(coarse))
    e = torch.as_tensor(rng.normal(size=coarse))
    got = F.interpolate(e[None, None], scale_factor=2, mode="trilinear",
                        align_corners=False)[0, 0]
    want = transfer.prolong_plain(e, cent)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-15 * want.abs().max().item()

    x = torch.as_tensor(rng.normal(size=tuple(2 * n for n in coarse)))
    w1 = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=torch.float64) / 8
    w = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :])[None, None]
    got = F.conv3d(F.pad(x[None, None], (1,) * 6, mode="replicate"), w, stride=2)[0, 0]
    want = transfer.restrict_plain(x, cent)
    assert got.shape == want.shape == coarse
    assert (got - want).abs().max().item() <= 1e-15 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16], ids=str)
def test_prolong_add_plain_is_x_plus_prolong(dtype):
    """The add form's plain path, through the kernel wrapper and the
    dispatch, is bit for bit ``x + prolong_plain(e)`` (bf16: P e rounded to
    bf16, then added in float32 and rounded once), without a launch."""
    lv = VED_LEVELS
    cent = lv[1].centering
    rng = np.random.default_rng(9)
    e = torch.as_tensor(rng.normal(size=lv[1].shape)).to(dtype)
    x = torch.as_tensor(rng.normal(size=lv[0].shape)).to(dtype)
    want = x + transfer.prolong_plain(e, cent)
    assert want.dtype == dtype
    if dtype == torch.bfloat16:
        p = transfer.prolong_plain(e, cent)
        assert torch.equal(want, (x.float() + p.float()).bfloat16())
    before = cuda_prolong.launches
    for got in (transfer.prolong_add_plain(x, e, cent),
                cuda_prolong_add(x, e, cent),
                transfer.prolong_add(x, e, cent, use_kernels=True),
                transfer.prolong_add(x, e, cent)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert cuda_prolong.launches == before


@pytest.mark.parametrize("cent", [("c", "v", "c"), ("v", "c", "v"), ("c", "c", "v")])
def test_prolong_add_matches_jax(cent):
    """``x + P e`` on mixed centrings against the JAX package's ``x +
    prolong(e)`` in float64."""
    coarse = (5, 6, 7)
    fine = tuple(transfer.fine_size(n, c) for n, c in zip(coarse, cent))
    rng = np.random.default_rng(len(set(cent)) + cent.count("c"))
    e, x = rng.normal(size=coarse), rng.normal(size=fine)
    got = cuda_prolong_add(torch.as_tensor(x), torch.as_tensor(e), cent)
    want = jnp.asarray(x) + jtransfer.prolong(jnp.asarray(e), cent)
    assert tuple(got.shape) == fine
    assert _rel(got, want) <= 1e-13


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("cent", list(itertools.product((CELL, VERTEX), repeat=3)),
                         ids="".join)
def test_restrict_tables_in_zyx_order_equal_plain(cent, dtype):
    """The order the restriction kernel (B3) rounds in: each axis's 4-tap
    table (zero-weight border taps included), z, then y, then x, every
    product and sum rounded on its own, is bit for bit ``restrict_plain``
    (on finite values a zero tap adds a zero), on odd and even sizes and a
    batch of six."""
    rng = np.random.default_rng(len(cent) + sum(c == CELL for c in cent))
    for fine in ((9, 11, 13), (10, 7, 12)):
        shape = tuple(n + (1 if c == VERTEX and n % 2 == 0 else 0)
                      for n, c in zip(fine, cent))
        for lead in ((), (6,)):
            x = torch.as_tensor(rng.normal(size=(*lead, *shape)) * 10).to(dtype)
            tables = [transfer.restrict_taps(n, c) for n, c in zip(shape, cent)]
            got = transfer.apply_taps_plain(x, tables, (0, 1, 2))
            want = transfer.restrict_plain(x, cent)
            assert got.dtype == want.dtype == dtype
            assert torch.equal(got, want)
