"""Port parity, smoothers and the coarse solve.

The stencil kernel's plain versions (what its wrappers run for a CPU tensor)
against the JAX package's Pallas half-sweep and residual in interpret mode;
the generic red-black Gauss-Seidel and Jacobi sweeps; and the coarsest-level
direct solver, including its back-substitution fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.core.symfield import as_sym_planes as jplanes
from multigridanisotropicdiffusion_tpu.ops import coarse as jcoarse
from multigridanisotropicdiffusion_tpu.ops import compressed as jcomp
from multigridanisotropicdiffusion_tpu.ops import dca as jdca
from multigridanisotropicdiffusion_tpu.ops import pallas_smoothers as jpallas
from multigridanisotropicdiffusion_tpu.ops import smoothers as jsmooth
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.models.mad import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.ops import coarse, compressed, dca, smoothers
from multigridanisotropicdiffusion_tpu_torch.ops.cuda_smoothers import (
    cuda_residual,
    halfsweep,
    launches,
    rbgs_sweep,
    rbgs_sweep_plain,
)

from .conftest import make_spd_tensor_field

SHAPE = (7, 9, 11)
SPACING = (1.0, 0.5, 2.0)
DT = 0.1


def _setup(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    mat = make_spd_tensor_field(rng, shape, len(shape), hi=3.0)
    spacing = SPACING[: len(shape)]
    t, jt = as_sym_planes(mat, shape), jplanes(jnp.asarray(mat), shape)
    x = rng.normal(size=shape) * 10.0
    b = rng.normal(size=shape) * 10.0
    return t, jt, spacing, x, b


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _bf16_ulp(v):
    """One bf16 unit in the last place of each value (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(v, np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _ops(t, jt, spacing, dtype=torch.float64, jdtype=jnp.float64):
    op = compressed.assemble_compressed_dca(t, spacing, DT).astype(dtype)
    jop = jax.tree.map(lambda a: a.astype(jdtype),
                       jcomp.assemble_compressed_dca(jt, spacing, DT))
    return op, jop


@pytest.mark.parametrize("color", [0, 1])
def test_halfsweep_matches_pallas_interpret(color):
    t, jt, spacing, x, b = _setup()
    op, jop = _ops(t, jt, spacing)
    before = launches.copy()
    got = halfsweep(op, torch.as_tensor(x), torch.as_tensor(b), color)
    want = jpallas.pallas_rbgs_halfsweep(jop, jnp.asarray(x), jnp.asarray(b),
                                         color, interpret=True)
    assert _rel(got, want) <= 1e-12
    assert launches == before  # a CPU tensor takes the plain version
    # out of place: the other colour keeps the old values exactly
    keep = ~smoothers.parity_mask(SHAPE) if color == 0 else smoothers.parity_mask(SHAPE)
    assert torch.equal(got[keep], torch.as_tensor(x)[keep])


def test_residual_matches_pallas_interpret():
    t, jt, spacing, x, b = _setup(seed=1)
    op, jop = _ops(t, jt, spacing)
    before = launches.copy()
    got = cuda_residual(op, torch.as_tensor(x), torch.as_tensor(b))
    want = jpallas.pallas_residual(jop, jnp.asarray(x), jnp.asarray(b),
                                   interpret=True)
    assert _rel(got, want) <= 1e-12
    assert launches == before


@pytest.mark.parametrize("kind", ["halfsweep0", "halfsweep1", "residual"])
def test_bf16_storage_matches_pallas_interpret(kind):
    """bf16 storage: both upcast to float32, compute, and round once; they
    agree to one bf16 ulp."""
    t, jt, spacing, x, b = _setup(seed=2)
    op, jop = _ops(t, jt, spacing, torch.bfloat16, jnp.bfloat16)
    xb, bb = torch.as_tensor(x).bfloat16(), torch.as_tensor(b).bfloat16()
    jx, jb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    if kind == "residual":
        got = cuda_residual(op, xb, bb)
        want = jpallas.pallas_residual(jop, jx, jb, interpret=True)
    else:
        color = int(kind[-1])
        got = halfsweep(op, xb, bb, color)
        want = jpallas.pallas_rbgs_halfsweep(jop, jx, jb, color, interpret=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.all(np.abs(got - want) <= _bf16_ulp(want)), np.max(np.abs(got - want))


@pytest.mark.parametrize("representation", ["stored", "compressed"])
def test_gauss_seidel_and_jacobi_match_jax(representation):
    t, jt, spacing, x, b = _setup(seed=3)
    if representation == "stored":
        op, jop = dca.assemble_dca(t, spacing, DT), jdca.assemble_dca(jt, spacing, DT)
    else:
        op, jop = _ops(t, jt, spacing)
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    jx, jb = jnp.asarray(x), jnp.asarray(b)
    assert _rel(smoothers.rb_gauss_seidel_sweep(op, xt, bt),
                jsmooth.rb_gauss_seidel_sweep(jop, jx, jb)) <= 1e-12
    assert _rel(smoothers.jacobi_sweep(op, xt, bt),
                jsmooth.jacobi_sweep(jop, jx, jb)) <= 1e-12
    if representation == "compressed":
        # the kernel-dispatching smoother takes the plain path on the CPU
        sweep = smoothers.make_smoother("gauss_seidel", use_kernels=True)
        assert torch.equal(sweep(op, xt, bt), rbgs_sweep_plain(op, xt, bt))
        assert torch.equal(rbgs_sweep(op, xt, bt), rbgs_sweep_plain(op, xt, bt))


def test_2d_compressed_with_kernels_uses_plain_on_cpu():
    t, jt, spacing, x, b = _setup(shape=(9, 12), seed=4)
    op = compressed.assemble_compressed_dca(t, spacing, DT)
    jop = jcomp.assemble_compressed_dca(jt, spacing, DT)
    got = smoothers.make_smoother("gs", use_kernels=True)(
        op, torch.as_tensor(x), torch.as_tensor(b))
    want = jpallas.pallas_rbgs_sweep(jop, jnp.asarray(x), jnp.asarray(b),
                                     interpret=True)
    assert _rel(got, want) <= 1e-12
    got = smoothers.make_residual(use_kernels=True)(
        op, torch.as_tensor(x), torch.as_tensor(b))
    assert _rel(got, jpallas.pallas_residual(jop, jnp.asarray(x), jnp.asarray(b),
                                             interpret=True)) <= 1e-12


@pytest.mark.parametrize("force_fallback", [False, True])
def test_coarse_solver_matches_jax(force_fallback):
    t, jt, spacing, x, b = _setup(shape=(6, 7, 8), seed=5)
    solver = coarse.build_coarse_solver(dca.assemble_dca(t, spacing, DT))
    jsolver = jcoarse.build_coarse_solver(jdca.assemble_dca(jt, spacing, DT))
    assert solver.inv_ok and bool(jsolver.inv_ok)
    assert _rel(solver.inv, jsolver.inv) <= 1e-12
    if force_fallback:
        solver = solver._replace(inv_ok=False)
        jsolver = jsolver._replace(inv_ok=jnp.asarray(False))
    got = coarse.coarse_solve(solver, torch.as_tensor(b))
    want = jcoarse.coarse_solve(jsolver, jnp.asarray(b))
    assert got.shape == b.shape
    assert _rel(got, want) <= 1e-12
    # the low-precision rhs of the defect cycles is solved in the setup
    # precision and cast back
    lo = coarse.coarse_solve(solver, torch.as_tensor(b, dtype=torch.float32))
    assert lo.dtype == torch.float32
    assert _rel(lo, want) <= 1e-6


@pytest.mark.parametrize(
    "make,check",
    [
        (lambda: MADConfig(coarse_operator="galerkin", operator_repr="matrix_free"),
         lambda cfg: cfg.operator_repr == "matrix_free"),
        (lambda: MADConfig(operator_repr="matrix_free"),
         lambda cfg: cfg.operator_repr == "matrix_free"),
        (lambda: MADConfig(smoother="chebyshev"), lambda cfg: cfg.smoother == "chebyshev"),
        (lambda: smoothers.make_smoother("chebyshev"),
         lambda fn: fn is smoothers.chebyshev_smoother),
    ],
    ids=["galerkin", "matrix_free", "chebyshev_config", "chebyshev_smoother"],
)
def test_a10_features_construct(make, check):
    """The matrix-free operator and the Chebyshev smoother (ROADMAP A10)
    are ported and construct."""
    assert check(make())


def _refusals():
    from multigridanisotropicdiffusion_tpu_torch.models.filters import (
        MultigridAnisotropicDiffusionImageFilter,
        VEDMultigridImageFilter,
    )
    from multigridanisotropicdiffusion_tpu_torch.models.trace import mad_diffusion_verbose
    from multigridanisotropicdiffusion_tpu_torch.models.ved import ved

    img, planes = np.zeros((8, 8)), np.zeros((3, 8, 8))
    return {
        "mad_mesh": lambda: mad_diffusion(img, planes, mesh=object(), device="cpu"),
        "ved_mesh": lambda: ved(np.zeros((8, 8, 8)), mesh=object(), device="cpu"),
        "trace_mesh": lambda: mad_diffusion_verbose(img, planes, mesh=object(),
                                                    device="cpu"),
        "mad_filter_mesh": lambda: MultigridAnisotropicDiffusionImageFilter(
            device="cpu").set_mesh(object()),
        "ved_filter_mesh": lambda: VEDMultigridImageFilter(device="cpu").set_mesh(object()),
    }


@pytest.mark.parametrize(
    "case", ["mad_mesh", "ved_mesh", "trace_mesh", "mad_filter_mesh", "ved_filter_mesh"])
def test_unported_features_refuse(case):
    """Every entry point that takes a mesh refuses one that is not a
    GridMesh (the distributed paths: tests/test_torch_dist_*.py); an
    unknown operator representation is an error."""
    with pytest.raises(TypeError, match="GridMesh"):
        _refusals()[case]()
    with pytest.raises(ValueError, match="operator_repr"):
        MADConfig(operator_repr="implicit")
