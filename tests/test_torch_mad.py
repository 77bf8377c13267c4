"""Port parity, the slice as a whole: ``mad_diffusion`` with the fast
configuration (``MADConfig.cuda()`` here, the JAX package's
``MADConfig.tpu()`` there) on the CPU, the reference configurations' cycle
counts, and the lena golden."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.core.grids import (
    build_level_descriptors as jlevels,
)
from multigridanisotropicdiffusion_tpu.core.symfield import as_sym_planes as jplanes
from multigridanisotropicdiffusion_tpu.models import mad as jmad
from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.models.mad import (
    FMG,
    SMOOTHER,
    VCYCLE,
    _single_device_ops,
    print_residual_trace,
    v_cycle,
)
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers
from multigridanisotropicdiffusion_tpu_torch.ops.cuda_assemble import (
    cuda_assemble_compressed_dca,
)
from multigridanisotropicdiffusion_tpu_torch.ops.cuda_transfer import (
    cuda_prolong,
    cuda_restrict,
)
from multigridanisotropicdiffusion_tpu_torch.utils.convert import hierarchy_from_numpy

from .conftest import make_spd_tensor_field

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
SHAPE = (16, 16, 16)
COUNTERS = (cuda_restrict, cuda_prolong, cuda_assemble_compressed_dca)


def _launches():
    """Every launch count a solve's kernels move: the stencil kernels' and
    the other wrappers'."""
    return [dict(cuda_smoothers.launches)] + [f.launches for f in COUNTERS]


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(shape=SHAPE, seed=0, hi=2.0):
    rng = np.random.default_rng(seed)
    tensor = make_spd_tensor_field(rng, shape, len(shape), hi=hi)
    image = rng.normal(size=shape) * 10.0
    return tensor, image


def test_slice_matches_jax_f64():
    """MADConfig.cuda(mixed_precision=False) on the CPU takes every kernel
    wrapper's plain path; against the JAX fast path (Pallas in interpret
    mode) it runs the same cycles to the same answer."""
    tensor, image = _inputs()
    kw = dict(time_step=0.1, tolerance=1e-10, max_cycles=50)
    before = _launches()
    res = mad_diffusion(image, tensor, config=MADConfig.cuda(mixed_precision=False, **kw),
                        device="cpu")
    assert _launches() == before
    jres = jmad.mad_diffusion(image, tensor,
                              config=jmad.MADConfig.tpu(mixed_precision=False, **kw))
    n = int(res.num_cycles[0])
    assert n == int(jres.num_cycles[0]) and n < 50
    assert float(res.final_residual[0]) <= 1e-10
    hist = res.residual_history[0, :n].numpy()
    jhist = np.asarray(jres.residual_history[0, :n])
    # 1e-9 relative, down to the f64 round-off floor of a relative residual
    # (a residual of ~1e-10 |b| is computed with an error of ~1e-16 |b|)
    np.testing.assert_allclose(hist, jhist, rtol=1e-9, atol=1e-15)
    assert _rel_l2(res.output, jres.output) <= 1e-10


def test_slice_bf16_defect_cycles_match_jax():
    tensor, image = _inputs(seed=1)
    kw = dict(time_step=0.1, tolerance=1e-8, max_cycles=50)
    res = mad_diffusion(image, tensor, config=MADConfig.cuda(**kw), device="cpu")
    jres = jmad.mad_diffusion(image, tensor, config=jmad.MADConfig.tpu(**kw))
    assert float(res.final_residual[0]) <= 1e-8
    assert float(jres.final_residual[0]) <= 1e-8
    assert abs(int(res.num_cycles[0]) - int(jres.num_cycles[0])) <= 1
    assert _rel_l2(res.output, jres.output) <= 1e-6


def test_jax_hierarchy_carried_across():
    """The port's cycles on exactly the operators the JAX package built."""
    tensor, image = _inputs(shape=(13, 12, 14), seed=2)
    spacing = (1.0, 0.5, 2.0)
    cfg = dict(time_step=0.1, tolerance=1e-10)
    jhier = jmad.build_hierarchy(jplanes(jnp.asarray(tensor), image.shape),
                                 jlevels(image.shape, spacing), 0.1,
                                 operator_repr="compressed")
    hier = hierarchy_from_numpy(jax.device_get(jhier))
    got = mad_diffusion(image, tensor, spacing, MADConfig.cuda(False, **cfg),
                        hierarchy=hier, device="cpu")
    own = mad_diffusion(image, tensor, spacing, MADConfig.cuda(False, **cfg),
                        device="cpu")
    jres = jmad.mad_diffusion(image, tensor, spacing,
                              jmad.MADConfig.tpu(False, **cfg), hierarchy=jhier)
    assert int(got.num_cycles[0]) == int(jres.num_cycles[0])
    assert _rel_l2(got.output, own.output) <= 1e-12
    assert _rel_l2(got.output, jres.output) <= 1e-10


def test_v_cycle_through_the_prolong_add_hook_matches_jax():
    """Two V-cycles on the JAX package's operators of a mixed-centring 3D
    hierarchy, the correction through the transfers' ``prolong_add`` hook
    (the add form's plain path on the CPU, no launch), against the JAX
    package's ``v_cycle``."""
    shape, spacing = (27, 24, 30), (1.0, 0.5, 2.0)
    tensor, image = _inputs(shape=shape, seed=5)
    jlv = jlevels(shape, spacing)
    jhier = jmad.build_hierarchy(jplanes(jnp.asarray(tensor), shape), jlv, 0.1,
                                 operator_repr="compressed")
    hier = hierarchy_from_numpy(jax.device_get(jhier))
    levels = build_level_descriptors(shape, spacing)
    assert {c for lv in levels for c in lv.centering} == {"c", "v"}
    ops = _single_device_ops(levels, MADConfig.cuda(False))
    calls = []

    def prolong_add(x, e, fl):
        calls.append(fl)
        return ops.transfers.prolong_add(x, e, fl)

    transfers = ops.transfers._replace(prolong_add=prolong_add)
    jsmooth = jmad.make_smoother("gauss_seidel")
    b = torch.as_tensor(image)
    x, jx = torch.zeros_like(b), jnp.zeros(shape)
    before = _launches()
    for _ in range(2):
        x = v_cycle(hier, levels, ops.smooth, 2, x, b, resid=ops.resid, transfers=transfers)
        jx = jmad.v_cycle(jhier, jlv, jsmooth, 2, jx, jnp.asarray(image))
    assert _launches() == before
    assert len(levels) == 3 and calls == [1, 0, 1, 0]
    assert _rel_l2(x, jx) <= 1e-12


@pytest.mark.parametrize("smoother", ["gauss_seidel", "weighted_jacobi"])
@pytest.mark.parametrize("cycle", [VCYCLE, FMG, SMOOTHER])
def test_2d_cycle_counts_match_jax(smoother, cycle):
    shape = (33, 32)
    tensor, image = _inputs(shape=shape, seed=3, hi=3.0)
    tol = 1e-3 if cycle == SMOOTHER else 1e-10
    kw = dict(time_step=0.1 if cycle != SMOOTHER else 0.01, tolerance=tol,
              max_cycles=100, cycle=cycle, smoother=smoother)
    res = mad_diffusion(image, tensor, config=MADConfig(**kw), device="cpu")
    jres = jmad.mad_diffusion(image, tensor, config=jmad.MADConfig(**kw))
    n = int(res.num_cycles[0])
    assert n == int(jres.num_cycles[0]) and n < 100
    np.testing.assert_allclose(res.residual_history[0, :n].numpy(),
                               np.asarray(jres.residual_history[0, :n]),
                               rtol=1e-9, atol=1e-15)
    assert _rel_l2(res.output, jres.output) <= 1e-10


def test_multiple_time_steps_and_trace_match_jax():
    tensor, image = _inputs(shape=(17, 16), seed=4)
    kw = dict(time_step=0.05, number_of_steps=3, tolerance=1e-10)
    res = mad_diffusion(image, tensor, config=MADConfig(**kw), device="cpu")
    jres = jmad.mad_diffusion(image, tensor, config=jmad.MADConfig(**kw))
    assert res.residual_history.shape == (3, 100)
    np.testing.assert_array_equal(res.num_cycles.numpy(), np.asarray(jres.num_cycles))
    assert _rel_l2(res.output, jres.output) <= 1e-10
    lines, jlines = [], []
    print_residual_trace(res, MADConfig(**kw), print_fn=lines.append)
    jmad.print_residual_trace(jres, jmad.MADConfig(**kw), print_fn=jlines.append)
    assert len(lines) == len(jlines) == 3 + int(np.sum(np.asarray(jres.num_cycles)))


def test_lena_matches_golden():
    """The reference's 2D GS V-cycle workload, as tests/test_goldens.py
    holds the JAX package to it."""
    g = np.load(os.path.join(GOLDEN_DIR, "lena_gs_v.npz"))
    img = g["input"].astype(np.float64)
    shape = img.shape
    tensor = (np.full(shape, 50.0), np.zeros(shape), np.full(shape, 30.0))
    cfg = MADConfig(time_step=0.1, number_of_steps=1, iterations_per_grid=2,
                    tolerance=1e-10, max_cycles=100)
    res = mad_diffusion(img, tensor, config=cfg, device="cpu")
    assert float(res.final_residual[0]) <= 1e-10
    assert _rel_l2(res.output.numpy(), g["output"]) < 1e-8


def test_default_device_is_the_card(monkeypatch):
    """With no ``device`` the solve runs on the CUDA card; without one it
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tensor, image = _inputs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mad_diffusion(image, tensor, config=MADConfig.cuda())


def test_mesh_refused():
    """A mesh that is not a GridMesh, and XLA's gspmd halo mode, are refused
    (the distributed solve itself: tests/test_torch_dist_mad.py)."""
    with pytest.raises(TypeError, match="GridMesh"):
        mad_diffusion(np.zeros(SHAPE), np.zeros((6, *SHAPE)), mesh=object())
    with pytest.raises(ValueError, match="overlap"):
        MADConfig.cuda(halo="gspmd")
