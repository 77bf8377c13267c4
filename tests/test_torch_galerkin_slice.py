"""Port parity, the Galerkin and 2D slice as a whole: ``mad_diffusion`` with
``MADConfig.cuda(coarse_operator='galerkin', ...)`` on the CPU (every kernel
wrapper's plain version) against the JAX package's
``MADConfig.tpu(coarse_operator='galerkin', ...)`` (Pallas in interpret
mode) in 3D and 2D, both variants, with and without pruning; lena through
the compressed operator and through collapsed Galerkin levels against its
golden; ``ved`` with Galerkin levels against the JAX ``ved``; and the JAX
Galerkin hierarchy, level by level and carried across into the port.
Float64; residual histories agree to 1e-9 relative down to the 1e-15
round-off floor (``tests/test_torch_mad.py``), operators to 1e-12 (the probe
sums in another order than the JAX probe)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigridanisotropicdiffusion_tpu.core.grids import (
    build_level_descriptors as jlevels,
)
from multigridanisotropicdiffusion_tpu.core.symfield import as_sym_planes as jplanes
from multigridanisotropicdiffusion_tpu.models import mad as jmad
from multigridanisotropicdiffusion_tpu.models import ved as jved
from multigridanisotropicdiffusion_tpu_torch import MADConfig, VEDConfig, mad_diffusion, ved
from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
from multigridanisotropicdiffusion_tpu_torch.utils.convert import hierarchy_from_numpy

from .conftest import make_spd_tensor_field

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
DT = 0.1


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(shape, seed=5):
    rng = np.random.default_rng(seed)
    return make_spd_tensor_field(rng, shape, len(shape), hi=2.0), rng.normal(size=shape) * 10.0


def _jax_hierarchy(shape, tensor, variant):
    """The hierarchy JAX's fast path builds (its cached, compiled builder:
    the one ``jmad.mad_diffusion`` ran just before)."""
    build = jmad._compiled_hierarchy_builder(jlevels(shape), DT, "galerkin", "compressed",
                                             variant, True)
    return jax.device_get(build(tuple(jplanes(jnp.asarray(tensor), shape))))


@pytest.mark.parametrize("shape,variant,prune", [
    ((13, 12, 14), "collapsed", 0.0),
    ((13, 12, 14), "exact", 0.0),
    ((13, 12, 14), "exact", 1e-4),
    ((33, 32), "collapsed", 0.0),
    ((22, 22), "exact", 0.0),
], ids=["3d-collapsed", "3d-exact", "3d-exact-pruned", "2d-collapsed", "2d-exact"])
def test_slice_matches_jax(shape, variant, prune):
    """The whole slice: ``MADConfig.cuda(coarse_operator='galerkin')`` on
    the CPU (every kernel wrapper's plain version) against the JAX fast path
    with the same Galerkin options, and the hierarchies level by level (a
    mixed vertex/cell chain in each: 13 -> 7 -> 4 vertex beside cell axes;
    22 -> 11 cell -> 6 vertex keeps radius 2)."""
    tensor, image = _inputs(shape)
    kw = dict(time_step=DT, tolerance=1e-10, max_cycles=50, coarse_operator="galerkin",
              galerkin_variant=variant, galerkin_prune_tol=prune)
    res = mad_diffusion(image, tensor, config=MADConfig.cuda(False, **kw), device="cpu")
    jres = jmad.mad_diffusion(image, tensor, config=jmad.MADConfig.tpu(False, **kw))
    n = int(res.num_cycles[0])
    assert n == int(jres.num_cycles[0]) and n < 50
    assert float(res.final_residual[0]) <= 1e-10
    np.testing.assert_allclose(res.residual_history[0, :n].numpy(),
                               np.asarray(jres.residual_history[0, :n]),
                               rtol=1e-9, atol=1e-15)
    assert _rel_l2(res.output, jres.output) <= 1e-10
    if prune:
        return
    hier = build_hierarchy(as_sym_planes(tensor, shape), build_level_descriptors(shape), DT,
                           "galerkin", "compressed", galerkin_variant=variant)
    jhier = _jax_hierarchy(shape, tensor, variant)
    for op, jop in zip(hier.operators[1:], jhier.operators[1:]):
        assert op.offsets == tuple(jop.offsets)
        np.testing.assert_allclose(op.coeffs.numpy(), np.stack(jop.coeffs),
                                   rtol=1e-12, atol=1e-14)
    assert {op.radius for op in hier.operators[1:]} == {1 if variant == "collapsed" else 2}
    np.testing.assert_allclose(hier.solver.inv.numpy(), jhier.solver.inv,
                               rtol=1e-10, atol=1e-13)


def test_jax_galerkin_hierarchy_carried_across():
    """``utils.convert`` carries a JAX Galerkin ``Hierarchy`` (stored levels
    with their offset tables) into the port, which solves on it as on its
    own."""
    shape = (13, 12, 14)
    tensor, image = _inputs(shape)
    cfg = MADConfig.cuda(False, time_step=DT, tolerance=1e-10, coarse_operator="galerkin",
                         galerkin_variant="exact")
    hier = hierarchy_from_numpy(_jax_hierarchy(shape, tensor, "exact"))
    assert max(op.radius for op in hier.operators[1:]) == 2
    got = mad_diffusion(image, tensor, config=cfg, hierarchy=hier, device="cpu")
    own = mad_diffusion(image, tensor, config=cfg, device="cpu")
    assert int(got.num_cycles[0]) == int(own.num_cycles[0])
    assert _rel_l2(got.output, own.output) <= 1e-12


@pytest.mark.parametrize("kw", [dict(operator_repr="compressed"),
                                dict(coarse_operator="galerkin")],
                         ids=["compressed", "galerkin-collapsed"])
def test_lena_matches_golden(kw):
    """The reference's 2D workload through the compressed operator and
    through collapsed Galerkin levels: the coarse operators shape only the
    correction, so both reach the golden's solution."""
    g = np.load(os.path.join(GOLDEN_DIR, "lena_gs_v.npz"))
    img = g["input"].astype(np.float64)
    shape = img.shape
    tensor = (np.full(shape, 50.0), np.zeros(shape), np.full(shape, 30.0))
    cfg = MADConfig(time_step=0.1, tolerance=1e-10, max_cycles=100, **kw)
    res = mad_diffusion(img, tensor, config=cfg, device="cpu")
    assert float(res.final_residual[0]) <= 1e-10
    assert _rel_l2(res.output.numpy(), g["output"]) < 1e-8


def test_ved_with_galerkin_matches_jax():
    """``VEDConfig`` passes the Galerkin options through to the solve."""
    rng = np.random.default_rng(6)
    shape = (14, 12, 10)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=float) for n in shape), indexing="ij")
    vol = 100.0 * np.exp(-((y - 5.3) ** 2 + (x - 4.6) ** 2) / 4.5)
    vol += rng.uniform(0.0, 10.0, size=shape)
    kw = dict(scales=(1.5,), diffusion_iterations=1, tolerance=1e-10,
              coarse_operator="galerkin", galerkin_variant="exact",
              galerkin_prune_tol=1e-4)
    cfg = VEDConfig(**kw)
    mad = cfg.mad_config()
    assert (mad.coarse_operator, mad.galerkin_variant, mad.galerkin_prune_tol) == (
        "galerkin", "exact", 1e-4)
    res = ved(vol, config=cfg, device="cpu")
    jres = jved.ved(vol, config=jved.VEDConfig(**kw))
    np.testing.assert_array_equal(res.diffusion.num_cycles.numpy(),
                                  np.asarray(jres.diffusion.num_cycles))
    assert _rel_l2(res.output, jres.output) <= 1e-10
