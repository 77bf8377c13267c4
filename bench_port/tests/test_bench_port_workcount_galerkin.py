"""The Galerkin counts behind ``kernels.galerkin_roofline`` and
``kernels.exact_stored_roofline``, against hand counts at small shapes and
against the port's own hierarchy."""

import pytest
import torch

from bench_port import workcount as wc
from bench_port import workcount_galerkin as wg
from bench_port import workcount_stored as ws
from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy


def test_the_products_bytes_match_a_hand_count():
    # 32^3 -> 16^3 -> 8^3 in float32: the compressed operator's 10 planes
    # read, level 1's 117 written; those read, level 2's 125 written
    assert wg.level_planes((32, 32, 32), "exact") == [10, 117, 125]
    assert wg.product_bytes((32, 32, 32), "exact", 4) == [
        (10 * 32768 + 117 * 4096) * 4, (117 * 4096 + 125 * 512) * 4]
    assert wg.level_planes((32, 32, 32), "collapsed") == [10, 27, 27]
    assert wg.product_bytes((32, 32, 32), "collapsed", 8) == [
        (10 * 32768 + 27 * 4096) * 8, (27 * 4096 + 27 * 512) * 8]
    assert wg.setup_seconds((32, 32, 32), "exact", 4) == pytest.approx(
        sum(wg.product_bytes((32, 32, 32), "exact", 4)) / wc.HBM_BYTES_PER_S, rel=1e-12)


def test_the_512_chain_moves_what_perf_md_counts():
    # 13.2 + 8.9 + 1.2 GB and the rest: ~23.5 GB, ~7.0 ms at 3.35 TB/s
    got = wg.product_bytes((512,) * 3, "exact", 4)
    assert [round(b / 1e9, 1) for b in got[:3]] == [13.2, 8.9, 1.2] and len(got) == 6
    assert wg.setup_seconds((512,) * 3, "exact", 4) == pytest.approx(7.0e-3, rel=0.01)
    # the collapsed chain: PERF.md's 2.84 ms of bytes
    assert wg.setup_seconds((512,) * 3, "collapsed", 4) == pytest.approx(2.84e-3, rel=0.01)


@pytest.mark.parametrize("variant", ["exact", "collapsed"])
@pytest.mark.parametrize("shape", [(32, 32, 32), (64, 48, 32)])
def test_the_plane_counts_are_the_ports(variant, shape):
    g = torch.Generator().manual_seed(5)
    rows = torch.randn((3, 3, *shape), generator=g, dtype=torch.float64)
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    tensor = torch.stack([(rows[i] * rows[j]).sum(0) + (2.0 if i == j else 0.0)
                          for i, j in pairs])
    levels = build_level_descriptors(shape)
    assert [lvl.shape for lvl in levels] == [s for s, _ in wc.level_shapes(shape)]
    hier = build_hierarchy(tensor, levels, 0.1, "galerkin", "compressed",
                           galerkin_variant=variant)
    planes = [hier.operators[0].planes.shape[0]] + [len(op.offsets)
                                                    for op in hier.operators[1:]]
    assert planes == wg.level_planes(shape, variant)


def test_vertex_centred_levels_are_not_counted():
    with pytest.raises(ValueError):
        wg.level_planes((33, 32, 32), "exact")
    with pytest.raises(ValueError):
        wg.level_planes((32, 32, 32), "pruned")


def test_an_exact_cycle_visits_each_stored_level_at_its_planes():
    # 512^3: level 1 (256^3) at 117 planes, 128^3 .. 16^3 at 125
    want = ws.visit_seconds((256,) * 3, 2, 117, 2) + sum(
        ws.visit_seconds((n,) * 3, 2, 125, 2) for n in (128, 64, 32, 16))
    assert wg.exact_cycle_seconds((512,) * 3, 2, 2) == pytest.approx(want, rel=1e-12)
    assert wg.exact_step_seconds((512,) * 3, 2, [2, 2, 4]) == pytest.approx(
        2 * want + wg.exact_cycle_seconds((512,) * 3, 2, 4), rel=1e-12)
    assert wg.exact_step_seconds((512,) * 3, 2, []) == 0.0


def test_b16_is_told_from_the_other_kernels():
    assert wg.is_product_kernel(
        "void (anonymous namespace)::galerkin_product_kernel<float, 5, 5, 1, 4, 0>"
        "(float const*, float*, int, int, int, int, int, int, int const*, float const*, int, "
        "(anonymous namespace)::Params)")
    assert not wg.is_product_kernel(
        "void mad::tile::tile_kernel<float, 1, 1, false, true, mad::stored::Taps<float, 124> >"
        "(...)")
    assert not wg.is_product_kernel("void (anonymous namespace)::restrict_kernel<float, 4>(...)")
