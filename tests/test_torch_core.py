"""Port parity, core layer: level lists, symmetric fields and the stored
stencil operator against the JAX package (float64 on the CPU)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.core import grids as jgrids
from multigridanisotropicdiffusion_tpu.core import stencil as jstencil
from multigridanisotropicdiffusion_tpu.core import symfield as jsym
from multigridanisotropicdiffusion_tpu_torch.core import grids, stencil, symfield

from .conftest import make_spd_tensor_field


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize(
    "shape,spacing",
    [
        ((512, 512, 512), None),
        ((256, 256, 256), (1.0, 0.5, 2.0)),
        ((69, 77, 69), (0.7, 0.7, 1.2)),
        ((17, 16), None),
        ((16, 16, 16), None),
    ],
)
def test_level_lists_match_jax(shape, spacing):
    def fields(levels):
        return [(lv.shape, lv.spacing, lv.centering, lv.index) for lv in levels]

    got = grids.build_level_descriptors(shape, spacing)
    want = jgrids.build_level_descriptors(shape, spacing)
    assert fields(got) == fields(want)
    assert len(got) >= 2


@pytest.mark.parametrize("ndim", [2, 3])
def test_symfield_round_trip(ndim):
    rng = np.random.default_rng(ndim)
    shape = (5, 6, 7)[:ndim]
    mat = make_spd_tensor_field(rng, shape, ndim)  # (*shape, D, D)
    planes = symfield.as_sym_planes(mat, shape)
    assert planes.shape == (symfield.sym_size(ndim), *shape)
    # every accepted layout gives the same stack
    lead = np.moveaxis(np.moveaxis(mat, -1, 0), -1, 0)  # (D, D, *shape)
    for other in (lead, tuple(planes), planes, torch.as_tensor(mat)):
        assert torch.equal(symfield.as_sym_planes(other, shape), planes)
    # and the JAX package's plane tuple agrees component for component
    jplanes = jsym.as_sym_planes(mat, shape)
    for k in range(len(jplanes)):
        np.testing.assert_array_equal(planes[k].numpy(), np.asarray(jplanes[k]))
    assert symfield.sym_pairs(ndim) == jsym.sym_pairs(ndim)


def test_symfield_rejects_bad_shapes():
    with pytest.raises(ValueError):
        symfield.as_sym_planes(np.zeros((4, 4, 3, 3)), (4, 5))
    with pytest.raises(ValueError):
        symfield.as_sym_planes((np.zeros((4, 5)),) * 2, (4, 5))


@pytest.mark.parametrize(
    "shape,radius", [((9, 10), 1), ((7, 8, 9), 1), ((7, 8, 9), 2)]
)
def test_stored_apply_and_residual_match_jax(shape, radius):
    rng = np.random.default_rng(len(shape) + radius)
    offsets = stencil.stencil_offsets(len(shape), radius)
    assert offsets == jstencil.stencil_offsets(len(shape), radius)
    coeffs = rng.normal(size=(len(offsets), *shape))
    x = rng.normal(size=shape)
    b = rng.normal(size=shape)
    jop = jstencil.StencilOperator(jnp.asarray(coeffs), offsets)
    op = stencil.StencilOperator(torch.as_tensor(coeffs), offsets)

    assert _rel(op.apply(torch.as_tensor(x)), jop.apply(jnp.asarray(x))) <= 1e-13
    assert _rel(op.offdiag_apply(torch.as_tensor(x)),
                jop.offdiag_apply(jnp.asarray(x))) <= 1e-13
    got = stencil.residual(op, torch.as_tensor(x), torch.as_tensor(b))
    want = jstencil.residual(jop, jnp.asarray(x), jnp.asarray(b))
    assert _rel(got, want) <= 1e-13
    np.testing.assert_allclose(
        float(stencil.l2_norm(torch.as_tensor(x))),
        float(jstencil.l2_norm(jnp.asarray(x))), rtol=1e-14,
    )
    np.testing.assert_array_equal(stencil.densify(op).numpy(),
                                  np.asarray(jstencil.densify(jop)))


def test_import_leaves_jax_out():
    """The port package and its kernel modules import without jax (and
    without CUDA, nvcc or triton)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import multigridanisotropicdiffusion_tpu_torch as m\n"
        "from multigridanisotropicdiffusion_tpu_torch.ops import "
        "cuda_smoothers, cuda_transfer, cuda_assemble, cuda_conv, "
        "cuda_vesselness, eigen3, hessian, matfree, smoothers\n"
        "from multigridanisotropicdiffusion_tpu_torch.models import ved, trace, filters\n"
        "from multigridanisotropicdiffusion_tpu_torch.utils import build, compare, "
        "convert, phantom, profile_ved, benchlog, checkpoint, io, native, profiling\n"
        "assert m.mad_diffusion and m.MADConfig and m.MADResult\n"
        "assert m.ved and m.VEDConfig and m.VEDResult\n"
        "bad = [k for k in set(sys.modules) - before\n"
        "       if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'multigridanisotropicdiffusion_tpu'\n"
        "       or k.startswith('multigridanisotropicdiffusion_tpu.')\n"
        "       or k == 'triton']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
