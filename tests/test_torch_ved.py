"""Port parity, the slice as a whole: ``ved`` with the fast configuration
(``VEDConfig.cuda()`` here, the JAX package's ``VEDConfig.tpu()`` there) and
the default one, on the CPU in float64.  The JAX package runs its XLA
pipeline on the CPU, so its full eigenframe is held against the port's
rank-1 B9 plain version; the phantom keeps every top eigenvalue apart (the
test asserts it), where the two agree to rounding."""

import dataclasses

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.models import ved as jved
from multigridanisotropicdiffusion_tpu_torch import VEDConfig, ved
from multigridanisotropicdiffusion_tpu_torch.models.ved import (
    _auto_z_slab,
    fused_vesselness_tensor,
    vesselness_measure,
)
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv, cuda_vesselness
from multigridanisotropicdiffusion_tpu_torch.ops.eigen3 import eigvalsh3
from multigridanisotropicdiffusion_tpu_torch.ops.hessian import (
    fd_factors,
    smoothed_field_valid_z,
)
from multigridanisotropicdiffusion_tpu_torch.utils.convert import ved_config_from_jax

SCALES = (0.775, 1.245, 2.0)
SPACING = (1.0, 0.9, 1.1)
COUNTERS = (cuda_conv.conv_z, cuda_conv.conv_yx, cuda_vesselness.fd_vesselness,
            cuda_vesselness.tensor_assembly)


def _phantom(shape=(20, 18, 16), seed=0):
    """Two bright tubes (along z and along x) on uniform noise."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=float) for n in shape), indexing="ij")
    vol = 100.0 * np.exp(-((y - 6.3) ** 2 + (x - 7.6) ** 2) / 4.5)
    vol += 80.0 * np.exp(-((z - 12.4) ** 2 + (y - 11.7) ** 2) / 8.0)
    return vol + rng.uniform(0.0, 10.0, size=shape)


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _min_top_gap(vol, scales):
    """The smallest top eigen-gap (relative to the matrix scale) of the
    winning Hessian over the active voxels, from the port's plain path."""
    u = torch.as_tensor(vol)
    best = None
    for sigma in scales:
        us = smoothed_field_valid_z(u, sigma, SPACING)
        best = cuda_vesselness.fd_vesselness(us, fd_factors(sigma, SPACING),
                                             (0.5, 0.5, 5.0), best,
                                             measure_fn=vesselness_measure)
    resp, h = best
    w = eigvalsh3(h)
    gap = (w[2] - w[1]) / h.abs().amax(0)
    return float(gap[resp > 0].min())


def test_slice_matches_jax_f64():
    vol = _phantom()
    assert _min_top_gap(vol, SCALES) > 1e-4  # no degenerate top eigenvalue
    kw = dict(scales=SCALES, diffusion_iterations=2, tolerance=1e-10)
    before = [f.launches for f in COUNTERS]
    res = ved(vol, SPACING, VEDConfig.cuda(mixed_precision=False, **kw), device="cpu")
    assert [f.launches for f in COUNTERS] == before  # plain versions on the CPU
    jres = jved.ved(vol, SPACING, jved.VEDConfig.tpu(mixed_precision=False, **kw))
    assert res.output.dtype == torch.float64
    np.testing.assert_array_equal(res.diffusion.num_cycles.numpy(),
                                  np.asarray(jres.diffusion.num_cycles))
    assert float(res.diffusion.final_residual.max()) <= 1e-10
    assert _rel_l2(res.output, jres.output) <= 1e-9
    assert np.abs(res.vesselness.numpy() - np.asarray(jres.vesselness)).max() <= 1e-10
    assert float(res.vesselness.max()) > 0.1
    np.testing.assert_allclose(res.tensor.numpy(), np.stack(jres.tensor),
                               rtol=0, atol=1e-9)


def test_default_config_matches_jax():
    """``VEDConfig()``: the stored operator and the generic pipeline path
    (full eigenframe), no kernels."""
    vol = _phantom(seed=1)
    kw = dict(scales=(0.5, 1.0, 2.0), diffusion_iterations=2, tolerance=1e-10)
    res = ved(vol, config=VEDConfig(**kw), device="cpu")
    jres = jved.ved(vol, config=jved.VEDConfig(**kw))
    np.testing.assert_array_equal(res.diffusion.num_cycles.numpy(),
                                  np.asarray(jres.diffusion.num_cycles))
    assert _rel_l2(res.output, jres.output) <= 1e-10
    assert np.abs(res.vesselness.numpy() - np.asarray(jres.vesselness)).max() <= 1e-10
    np.testing.assert_allclose(res.tensor.numpy(), np.stack(jres.tensor),
                               rtol=0, atol=1e-9)


def test_bf16_defect_cycles_match_jax():
    """bf16 inner defect cycles, at tests/test_torch_mad.py's bf16 bounds."""
    vol = _phantom(seed=2)
    kw = dict(scales=SCALES, diffusion_iterations=2, tolerance=1e-8)
    res = ved(vol, config=VEDConfig.cuda(**kw), device="cpu")
    jres = jved.ved(vol, config=jved.VEDConfig.tpu(**kw))
    assert float(res.diffusion.final_residual.max()) <= 1e-8
    assert float(np.asarray(jres.diffusion.final_residual).max()) <= 1e-8
    assert np.all(np.abs(res.diffusion.num_cycles.numpy()
                         - np.asarray(jres.diffusion.num_cycles)) <= 1)
    assert _rel_l2(res.output, jres.output) <= 1e-6


@pytest.mark.parametrize("use_kernels", [False, True])
def test_tiled_pipeline_matches_untiled(use_kernels):
    """z slabs over a shared max-radius halo, with valid-mode z passes, give
    the untiled result."""
    u = torch.as_tensor(_phantom((24, 14, 12), seed=3))
    args = (SCALES, SPACING, 0.5, 0.5, 5.0, 0.01, 5.0, 10.0)
    want = fused_vesselness_tensor(u, *args, None, "smooth_fd", use_kernels=use_kernels)
    got = fused_vesselness_tensor(u, *args, 6, "smooth_fd", use_kernels=use_kernels)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-11, atol=1e-13)
    with pytest.raises(ValueError, match="divide"):
        fused_vesselness_tensor(u, *args, 5, "smooth_fd")


def test_auto_z_slab_gives_eight_slabs_at_512():
    assert _auto_z_slab((512, 512, 512), 0) == 64
    assert _auto_z_slab((512, 512, 512), 0) == jved._auto_z_slab((512, 512, 512), 0)
    assert _auto_z_slab((64, 64, 64), 0) is None
    assert _auto_z_slab((64, 64, 64), None) is None and _auto_z_slab((64, 64, 64), 8) == 8


def test_config_carried_across_from_jax():
    jcfg = jved.VEDConfig.tpu(scales=(1.0, 2.0), tolerance=1e-7)
    cfg = ved_config_from_jax(jcfg)
    assert cfg == VEDConfig.cuda(scales=(1.0, 2.0), tolerance=1e-7)
    assert cfg.use_kernels and cfg.operator_repr == "compressed"
    assert cfg.defect_dtype == "bfloat16" and cfg.hessian_mode == "smooth_fd"
    mad = cfg.mad_config()
    assert mad.number_of_steps == cfg.diffusion_iterations and mad.use_kernels
    assert ved_config_from_jax(jved.VEDConfig()) == VEDConfig()


def test_refusals(monkeypatch):
    vol = _phantom()
    with pytest.raises(TypeError, match="GridMesh"):  # the mesh path: test_torch_dist_ved
        ved(vol, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        ved(np.zeros((8, 8)), device="cpu")
    # the matrix-free operator is ported: the VED flag maps to it
    assert VEDConfig(matrix_free=True).mad_config().operator_repr == "matrix_free"
    with pytest.raises(ValueError, match="galerkin_variant"):
        VEDConfig(galerkin_variant="direct")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ved(vol, config=VEDConfig.cuda())


def test_iterations_recompute_the_tensor():
    """iterations=2 is the filter re-applied to iteration 1's output."""
    vol = _phantom((12, 14, 12), seed=4)
    cfg1 = VEDConfig(scales=(0.5, 1.0), omega=1.5, diffusion_iterations=1,
                     tolerance=1e-8)
    r1 = ved(vol, config=cfg1, device="cpu")
    r2 = ved(vol, config=dataclasses.replace(cfg1, iterations=2), device="cpu")
    r1b = ved(r1.output, config=cfg1, device="cpu")
    torch.testing.assert_close(r2.output, r1b.output, rtol=0, atol=0)
    assert float((r2.tensor - r1.tensor).abs().max()) > 0.0
