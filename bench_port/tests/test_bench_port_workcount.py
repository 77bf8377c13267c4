"""The level-visit work counts behind ``kernels.solve_roofline``, against hand
counts at small shapes."""

import math

import pytest

from bench_port import workcount as wc
from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors


@pytest.mark.parametrize("shape", [(512, 512, 512), (256, 256, 256), (69, 77, 69),
                                   (16, 16, 16), (11, 6, 40)])
def test_levels_follow_the_ports_grid_rule(shape):
    port = [(lvl.shape, lvl.centering) for lvl in build_level_descriptors(shape)]
    assert wc.level_shapes(shape) == port


def test_cycle_matches_a_hand_count():
    # 16^3 -> 8^3 (cell-centred): one level visit and the coarsest solve, bf16
    n, nc, p, s = 4096, 512, 10, 2
    down = p * n * s + n * s + n * s + nc * s  # operator, b; x and rhs out
    up = p * n * s + 3 * n * s + nc * s  # operator, x, b, correction; x out
    assert down + up == 206848
    flops = (2 * 2 * 29 + 30) * n + (16384 + 8192 + 4096) + (4096 + 8192 + 16384) + n
    visit = max((down + up) / wc.HBM_BYTES_PER_S, flops / wc.FP32_FLOPS_PER_S)
    coarsest = max((nc * nc * 4 + 2 * nc * s) / wc.HBM_BYTES_PER_S,
                   2 * nc * nc / wc.FP32_FLOPS_PER_S)
    assert wc.cycle_seconds((16, 16, 16), 2, p, s, 4) == pytest.approx(visit + coarsest, rel=1e-12)


def test_step_matches_a_hand_count():
    shape, p, s = (16, 16, 16), 10, 4
    n = 4096
    cycles = [2, 4]
    first = (p * n * s + n * s + n * 2) / wc.HBM_BYTES_PER_S
    outer = [(p * n * s + 2 * n * s + n * 2 + n * s + n * 4) / wc.HBM_BYTES_PER_S,
             (p * n * s + 2 * n * s + n * 4 + n * s) / wc.HBM_BYTES_PER_S]
    inner = [wc.cycle_seconds(shape, 2, p, b, s) for b in cycles]
    assert wc.step_seconds(shape, 2, p, cycles, s) == pytest.approx(
        first + sum(outer) + sum(inner), rel=1e-12)


def test_cycle_precision_follows_the_switch_window():
    # tolerance 1e-6, switch 2000: full precision after a residual in (1e-4, 2e-3]
    assert wc.cycle_bytes([5.7e-3, 4.1e-5, 5.3e-7], 3, 1e-6, 2000.0, 4, 2) == [2, 2, 2]
    assert wc.cycle_bytes([3e-3, 1.5e-3, 2e-5, 4e-7], 4, 1e-6, 2000.0, 4, 2) == [2, 2, 4, 2]
    assert wc.cycle_bytes([1.5e-3, 4e-7], 2, 1e-6, 0.0, 4, 2) == [2, 2]


def visit_pass_bytes(shape, nu, planes, value_bytes, fused):
    """Bytes a level-0 visit moves when each smoothing pass and the residual
    is a separate pass over the level (each reads the operator, ``x`` and
    ``b`` and writes ``x`` or the residual): a red and a black half-sweep per
    sweep (today's kernels), or one fused red+black sweep."""
    passes = 2 * nu * (1 if fused else 2) + 1
    return passes * (planes + 3) * math.prod(shape) * value_bytes


@pytest.mark.parametrize("shape", [(512, 512, 512), (256, 256, 256)])
@pytest.mark.parametrize("value_bytes", [2, 4])
def test_fused_sweep_counts_no_more_than_two_half_sweeps(shape, value_bytes):
    count = wc.cycle_seconds(shape, 2, wc.PLANES_3D, value_bytes, 4) * wc.HBM_BYTES_PER_S
    fused = visit_pass_bytes(shape, 2, wc.PLANES_3D, value_bytes, fused=True)
    halves = visit_pass_bytes(shape, 2, wc.PLANES_3D, value_bytes, fused=False)
    assert fused <= halves
    # the whole cycle's count, coarse levels and all, stays under either
    # implementation's level-0 traffic alone: a fused sweep can raise the
    # share, never past 100%
    assert count <= fused
    assert 3.5 < halves / count < 5.5
    assert math.prod(shape) * (2 * wc.PLANES_3D + 5) * value_bytes < count
