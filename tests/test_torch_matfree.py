"""Port parity, the matrix-free DCA operator (``ops/matfree.py``) and the
Chebyshev smoother (``ops/smoothers.py``): against the JAX package's, in
float64 on the CPU, and against the port's own stored operator.

Tolerances: the operator applies, smoothers and Gershgorin sums agree with
JAX's to 1e-12 (relative to the largest value; the sums run in the same
order); solves to tolerance 1e-10 run the same cycle count, residual
histories within 1e-9 relative above the round-off floor, outputs within
1e-10 relative L2; Galerkin levels built over the matrix-free level agree
plane for plane to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.core.grids import build_level_descriptors as jlevels
from multigridanisotropicdiffusion_tpu.core.symfield import as_sym_planes as jplanes
from multigridanisotropicdiffusion_tpu.models import mad as jmad
from multigridanisotropicdiffusion_tpu.ops import compressed as jcompressed
from multigridanisotropicdiffusion_tpu.ops import dca as jdca
from multigridanisotropicdiffusion_tpu.ops import matfree as jmatfree
from multigridanisotropicdiffusion_tpu.ops import smoothers as jsmoothers
from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
from multigridanisotropicdiffusion_tpu_torch.ops import compressed, cuda_smoothers, dca, smoothers
from multigridanisotropicdiffusion_tpu_torch.ops.matfree import MatrixFreeDCAOperator
from multigridanisotropicdiffusion_tpu_torch.utils.convert import (
    mad_config_from_jax,
    operator_from_numpy,
)

from .conftest import make_spd_tensor_field

DT = 0.1
CASES = [((7, 6), (1.0, 1.0)), ((8, 9), (0.5, 2.0)), ((6, 7, 8), (1.0, 0.5, 2.0)),
         ((7, 7, 7), (0.3125, 0.3125, 0.5))]


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ops(shape, spacing, seed=0):
    """The port's and JAX's matrix-free operators on one tensor field."""
    rng = np.random.default_rng(seed)
    tensor = make_spd_tensor_field(rng, shape, len(shape))
    jp = jplanes(tensor, shape)
    mf = MatrixFreeDCAOperator(as_sym_planes(tensor, shape), spacing, DT)
    jmf = jmatfree.MatrixFreeDCAOperator(tuple(jnp.asarray(p) for p in jp), spacing, DT)
    return mf, jmf, rng


@pytest.mark.parametrize("shape,spacing", CASES)
def test_apply_diag_and_rowsum_match_jax(shape, spacing):
    mf, jmf, rng = _ops(shape, spacing)
    x = rng.normal(size=shape)
    _close(mf.apply(torch.as_tensor(x)), jmf.apply(jnp.asarray(x)))
    _close(mf.offdiag_apply(torch.as_tensor(x)), jmf.offdiag_apply(jnp.asarray(x)))
    _close(mf.diag, jmf.diag)
    _close(mf.offdiag_abs_rowsum(), jmf.offdiag_abs_rowsum())
    assert mf.offsets == tuple(jmf.offsets) and mf.shape == shape and mf.ndim == len(shape)
    # equal to the port's stored (folded) operator, as the JAX package holds its own
    stored = dca.assemble_dca(mf.tensor, spacing, DT)
    _close(mf.apply(torch.as_tensor(x)), stored.apply(torch.as_tensor(x)))
    # a batch of fields at once (the Galerkin probes)
    xb = torch.as_tensor(rng.normal(size=(3, *shape)))
    _close(mf.apply(xb), torch.stack([mf.apply(v) for v in xb]))
    carried = operator_from_numpy(jax.device_get(jmf))
    assert isinstance(carried, MatrixFreeDCAOperator)
    _close(carried.apply(torch.as_tensor(x)), jmf.apply(jnp.asarray(x)))


@pytest.mark.parametrize("shape,spacing", [CASES[1], CASES[2]])
def test_smoothers_match_jax(shape, spacing):
    mf, jmf, rng = _ops(shape, spacing, seed=1)
    x, b = rng.normal(size=shape), rng.normal(size=shape)
    tx, tb, jx, jb = torch.as_tensor(x), torch.as_tensor(b), jnp.asarray(x), jnp.asarray(b)
    _close(smoothers.jacobi_sweep(mf, tx, tb), jsmoothers.jacobi_sweep(jmf, jx, jb))
    _close(smoothers.rb_gauss_seidel_sweep(mf, tx, tb),
           jsmoothers.rb_gauss_seidel_sweep(jmf, jx, jb))
    _close(smoothers.chebyshev_smoother(mf, tx, tb), jsmoothers.chebyshev_smoother(jmf, jx, jb))
    # with kernels on: no stencil kernel for this operator, the plain sweep
    assert not cuda_smoothers.kernel_takes(mf)
    _close(smoothers.make_smoother("gauss_seidel", use_kernels=True)(mf, tx, tb),
           jsmoothers.rb_gauss_seidel_sweep(jmf, jx, jb))


@pytest.mark.parametrize("form", ["stored", "compressed"])
def test_chebyshev_matches_jax_on_plane_operators(form):
    shape, spacing = (9, 8, 7), (1.0, 0.5, 2.0)
    rng = np.random.default_rng(2)
    tensor = make_spd_tensor_field(rng, shape, 3, hi=3.0)
    planes = as_sym_planes(tensor, shape)
    jp = tuple(jnp.asarray(p) for p in jplanes(tensor, shape))
    if form == "stored":
        op, jop = dca.assemble_dca(planes, spacing, DT), jdca.assemble_dca(jp, spacing, DT)
    else:
        op = compressed.assemble_compressed_dca(planes, spacing, DT)
        jop = jcompressed.assemble_compressed_dca(jp, spacing, DT)
    _close(op.offdiag_abs_rowsum(), jop.offdiag_abs_rowsum())
    x, b = rng.normal(size=shape), rng.normal(size=shape)
    got = torch.as_tensor(x)
    want = jnp.asarray(x)
    for _ in range(3):
        got = smoothers.chebyshev_smoother(op, got, torch.as_tensor(b))
        want = jsmoothers.chebyshev_smoother(jop, want, jnp.asarray(b))
    _close(got, want)
    assert smoothers.make_smoother("cheby") is smoothers.chebyshev_smoother


@pytest.mark.parametrize("shape,jkw", [
    ((33, 32), dict(matrix_free=True)),
    ((33, 32), dict(matrix_free=True, coarse_operator="galerkin")),
    ((13, 12, 14), dict(operator_repr="matrix_free")),
    ((33, 32), dict(smoother="chebyshev")),
    ((13, 12, 14), dict(smoother="chebyshev", operator_repr="compressed")),
], ids=["2d_dca", "2d_galerkin", "3d_dca", "2d_chebyshev", "3d_chebyshev"])
def test_solves_match_jax(shape, jkw):
    # tests/test_matfree.py's and tests/test_chebyshev.py's inputs
    rng = np.random.default_rng(3)
    tensor = make_spd_tensor_field(rng, shape, len(shape), hi=3.0 if len(shape) == 2 else 2.0)
    image = rng.normal(size=shape) * (100.0 if len(shape) == 2 else 10.0)
    spacing = None if len(shape) == 2 else (1.0, 0.5, 2.0)
    jcfg = jmad.MADConfig(time_step=DT, tolerance=1e-10, **jkw)
    cfg = mad_config_from_jax(jcfg)
    assert cfg.operator_repr == jcfg.effective_operator_repr
    res = mad_diffusion(image, tensor, spacing, cfg, device="cpu")
    jres = jmad.mad_diffusion(image, tensor, spacing, jcfg)
    n = int(res.num_cycles[0])
    assert n == int(jres.num_cycles[0]) and float(res.final_residual[0]) <= 1e-10
    # 1e-9 relative down to the round-off floor of a relative residual: 1e-15
    # for a few V-cycles (tests/test_torch_mad.py), 1e-14 after the ~50
    # slowly contracting Chebyshev cycles
    np.testing.assert_allclose(res.residual_history[0, :n].numpy(),
                               np.asarray(jres.residual_history[0, :n]), rtol=1e-9,
                               atol=1e-14 if cfg.smoother == "chebyshev" else 1e-15)
    assert _rel_l2(res.output, jres.output) <= 1e-10


def test_galerkin_levels_over_matrix_free_match_jax():
    """Level 1 of a Galerkin hierarchy probed through the matrix-free level
    0, plane for plane (``tests/test_matfree.py``'s configuration)."""
    shape, spacing = (13, 12, 14), (1.0, 0.5, 2.0)
    rng = np.random.default_rng(4)
    tensor = make_spd_tensor_field(rng, shape, 3, hi=2.0)
    hier = build_hierarchy(as_sym_planes(tensor, shape), build_level_descriptors(shape, spacing),
                           DT, "galerkin", "matrix_free")
    jhier = jmad.build_hierarchy(jplanes(jnp.asarray(tensor), shape), jlevels(shape, spacing),
                                 DT, "galerkin", "matrix_free")
    assert isinstance(hier.operators[0], MatrixFreeDCAOperator)
    for op, jop in zip(hier.operators[1:], jhier.operators[1:]):
        assert op.offsets == tuple(jop.offsets)
        _close(op.coeffs, np.stack(jop.coeffs))


def test_kernel_config_with_matrix_free_matches_jax():
    """``MADConfig.cuda(operator_repr='matrix_free')`` in float64: the
    transfers and tensor restriction take their kernels' plain versions,
    the operator its plain sweeps; against JAX's ``MADConfig.tpu``."""
    shape = (13, 12, 14)
    rng = np.random.default_rng(5)
    tensor = make_spd_tensor_field(rng, shape, 3, hi=2.0)
    image = rng.normal(size=shape) * 10.0
    kw = dict(time_step=DT, tolerance=1e-10, operator_repr="matrix_free")
    res = mad_diffusion(image, tensor, config=MADConfig.cuda(False, **kw), device="cpu")
    jres = jmad.mad_diffusion(image, tensor, config=jmad.MADConfig.tpu(False, **kw))
    assert int(res.num_cycles[0]) == int(jres.num_cycles[0])
    assert _rel_l2(res.output, jres.output) <= 1e-10
    # bf16 defect cycles: the operator's planes are read in float32
    lo = mad_diffusion(image, tensor, config=MADConfig.cuda(**dict(kw, tolerance=1e-8)),
                       device="cpu")
    assert float(lo.final_residual[0]) <= 1e-8
    assert _rel_l2(lo.output, res.output) <= 1e-6
