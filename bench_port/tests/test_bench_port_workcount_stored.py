"""The stored-level work counts behind ``kernels.stored_roofline``, against
hand counts at small shapes."""

import pytest

from bench_port import workcount as wc
from bench_port import workcount_stored as ws


def test_a_visit_matches_a_hand_count():
    # a 16^3 level, 27 planes, bf16: planes, b and x in down and up, x out
    n, p, s = 4096, 27, 2
    moved = (2 * (p + 2) + 1) * n * s
    assert moved == 483328
    flops = (2 * 2 * (2 * 26 + 2) + (2 * 26 + 3)) * n  # 4 sweeps and a residual
    assert flops == 271 * n
    want = max(moved / wc.HBM_BYTES_PER_S, flops / wc.FP32_FLOPS_PER_S)
    assert ws.visit_seconds((16, 16, 16), 2, p, s) == pytest.approx(want, rel=1e-12)


def test_a_cycle_visits_the_stored_levels_only():
    # 32^3 -> 16^3 -> 8^3: level 0 is compressed, 8^3 the dense solve
    assert ws.cycle_seconds((32, 32, 32), 2, 27, 2) == ws.visit_seconds((16, 16, 16), 2, 27, 2)
    # 512^3: levels 256^3 .. 16^3 in turn
    want = sum(ws.visit_seconds((n,) * 3, 2, 27, 4) for n in (256, 128, 64, 32, 16))
    assert ws.cycle_seconds((512,) * 3, 2, 27, 4) == pytest.approx(want, rel=1e-12)


def test_a_step_adds_its_cycles_at_their_precisions():
    shape = (64, 48, 40)
    assert ws.step_seconds(shape, 2, 27, [2, 4, 2]) == pytest.approx(
        2 * ws.cycle_seconds(shape, 2, 27, 2) + ws.cycle_seconds(shape, 2, 27, 4), rel=1e-12)
    assert ws.step_seconds(shape, 2, 27, []) == 0.0


@pytest.mark.parametrize("value_bytes", [2, 4])
def test_the_count_stays_under_the_kernels_reads(value_bytes):
    # each of a visit's 9 launches (8 half-sweeps, the residual) reads the
    # planes, b and x and writes a value: the count reads the planes twice
    n = 256 ** 3
    launches = 9 * (27 + 3) * n * value_bytes
    count = ws.visit_seconds((256,) * 3, 2, 27, value_bytes) * wc.HBM_BYTES_PER_S
    assert count < launches
    assert 4.0 < launches / count < 5.0


def test_b12_is_told_from_b1_by_its_contraction():
    assert ws.is_stored_kernel(
        "void mad::tile::tile_kernel<float, 1, 1, false, true, mad::stored::Taps<float, 26> >"
        "(float const*, float const*, float const*, float*, int, int, int, int)")
    assert not ws.is_stored_kernel(
        "void mad::tile::tile_kernel<__nv_bfloat16, 1, 1, false, true, "
        "(anonymous namespace)::Compressed<__nv_bfloat16, false> >(...)")
    assert not ws.is_stored_kernel("void (anonymous namespace)::restrict_kernel<float, 4>(...)")
