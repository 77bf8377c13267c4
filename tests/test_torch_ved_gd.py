"""Port parity, the reference-faithful VED: ``ved`` in
``hessian_mode='gaussian_derivative'`` with ``use_kernels=True`` on the CPU
(the B6/B10 wrappers' plain versions, the prefix-shared Hessian, then B15's
and B9's plain versions: eigensolves, select and tensor) against the JAX
``ved`` with ``VEDConfig.tpu(hessian_mode='gaussian_derivative')``, untiled
and in z slabs of 8, in float64.

The JAX side computes the full eigenframe of the winning Hessian (its
generic pipeline path), the port B9's rank-1 form; the two tensors agree to
rounding wherever the top eigenvalue is simple.  Tolerances as in
``tests/test_torch_ved.py``: output 1e-9 relative L2, vesselness 1e-10,
tensor 1e-9 absolute."""

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.models import ved as jved
from multigridanisotropicdiffusion_tpu_torch import VEDConfig, ved
from multigridanisotropicdiffusion_tpu_torch.models.ved import _fused_scales
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv, cuda_vesselness
from multigridanisotropicdiffusion_tpu_torch.utils.convert import ved_config_from_jax

SCALES = (1.0, 2.0)
SPACING = (1.0, 0.9, 1.1)


def _phantom(shape=(16, 18, 14), seed=0):
    """Two bright tubes (along z and along x) on uniform noise."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=float) for n in shape), indexing="ij")
    vol = 100.0 * np.exp(-((y - 6.3) ** 2 + (x - 7.6) ** 2) / 4.5)
    vol += 80.0 * np.exp(-((z - 9.4) ** 2 + (y - 11.7) ** 2) / 8.0)
    return vol + rng.uniform(0.0, 10.0, size=shape)


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("z_slab", [None, 8])
def test_gaussian_derivative_ved_matches_jax_f64(z_slab):
    vol = _phantom()
    kw = dict(scales=SCALES, diffusion_iterations=1, tolerance=1e-10,
              hessian_mode="gaussian_derivative", pipeline_z_slab=z_slab)
    jcfg = jved.VEDConfig.tpu(mixed_precision=False, **kw)
    cfg = VEDConfig.cuda(mixed_precision=False, **kw)
    assert ved_config_from_jax(jcfg) == cfg
    before = (cuda_conv.conv_z.launches, cuda_conv.conv_y.launches,
              cuda_conv.conv_x.launches)
    res = ved(vol, SPACING, cfg, device="cpu")
    # the plain versions on the CPU: no launch
    assert (cuda_conv.conv_z.launches, cuda_conv.conv_y.launches,
            cuda_conv.conv_x.launches) == before
    jres = jved.ved(vol, SPACING, jcfg)
    np.testing.assert_array_equal(res.diffusion.num_cycles.numpy(),
                                  np.asarray(jres.diffusion.num_cycles))
    assert float(res.diffusion.final_residual.max()) <= 1e-10
    assert _rel_l2(res.output, jres.output) <= 1e-9
    assert np.abs(res.vesselness.numpy() - np.asarray(jres.vesselness)).max() <= 1e-10
    assert float(res.vesselness.max()) > 0.1
    np.testing.assert_allclose(res.tensor.numpy(), np.stack(jres.tensor), rtol=0, atol=1e-9)


def test_gaussian_derivative_bf16_pipeline_matches_jax():
    """bfloat16 storage: every single-axis pass and every scaled plane round
    to bf16 on both sides; the math after the Hessian runs in float32.  The
    two pipelines agree to float32 rounding of the eigensolves."""
    vol = _phantom(seed=1)
    kw = dict(scales=SCALES, diffusion_iterations=1, tolerance=1e-10,
              hessian_mode="gaussian_derivative", pipeline_dtype="bfloat16")
    res = ved(vol, SPACING, VEDConfig.cuda(mixed_precision=False, **kw), device="cpu")
    jres = jved.ved(vol, SPACING, jved.VEDConfig.tpu(mixed_precision=False, **kw))
    assert res.vesselness.dtype == torch.float32
    assert np.abs(res.vesselness.numpy() - np.asarray(jres.vesselness)).max() <= 1e-5
    assert _rel_l2(res.output, jres.output) <= 1e-6


def test_kernel_path_matches_the_generic_body(monkeypatch):
    """``use_kernels=True`` takes the B15 path (on the CPU B15's plain
    version, the generic path's per-scale body, then B9's rank-1 tensor):
    the generic path's response bit for bit, its tensor to float64
    rounding."""
    calls = []
    wrapped = cuda_vesselness.hessian_vesselness
    monkeypatch.setattr(cuda_vesselness, "hessian_vesselness",
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    u = torch.as_tensor(_phantom((10, 12, 9), seed=2))
    args = (SCALES, SPACING, 0.5, 0.5, 5.0, 0.01, 5.0, 10.0, None, "gaussian_derivative")
    resp, t = _fused_scales(u, *args, use_kernels=True)
    assert len(calls) == len(SCALES)
    want_resp, want_t = _fused_scales(u, *args, use_kernels=False)
    assert len(calls) == len(SCALES)
    assert torch.equal(resp, want_resp) and float(resp.max()) > 0.1
    assert t.shape == want_t.shape and float((t - want_t).abs().max()) <= 1e-13
