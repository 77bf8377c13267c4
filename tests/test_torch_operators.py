"""Port parity, operator assembly: the stored and compressed DCA operators
against the JAX package (float64 on the CPU), and carrying a JAX hierarchy
across with ``utils.convert``."""

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
from multigridanisotropicdiffusion_tpu.ops import compressed as jcomp
from multigridanisotropicdiffusion_tpu.ops import dca as jdca
from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.models import mad
from multigridanisotropicdiffusion_tpu_torch.ops import compressed, dca
from multigridanisotropicdiffusion_tpu_torch.ops.cuda_assemble import (
    cuda_assemble_compressed_dca,
)
from multigridanisotropicdiffusion_tpu_torch.utils.convert import hierarchy_from_numpy

from .conftest import make_spd_tensor_field

CASES = [
    ((9, 10, 11), (1.0, 0.5, 2.0)),
    ((6, 8, 10), (0.7, 1.3, 1.0)),
    ((9, 10), (1.0, 0.5)),
    ((12, 7), (2.0, 0.8)),
]
DT = 0.1


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    mat = make_spd_tensor_field(rng, shape, len(shape), hi=3.0)
    return mat, as_sym_planes(mat, shape), jplanes(jnp.asarray(mat), shape)


def _assert_plane(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.max(np.abs(want)), 1e-300)
    err = np.max(np.abs(got - want))
    assert err <= 1e-12 * scale, f"{what}: {err} vs max {scale}"


def _jax_compressed_planes(jop):
    out = []
    for d in range(jop.ndim):
        out += [jop.face_p[d], jop.face_m[d]]
    return out + list(jop.mixed) + [jop.diag_plane]


@pytest.mark.parametrize("shape,spacing", CASES)
def test_assemble_dca_matches_jax(shape, spacing):
    _, t, jt = _inputs(shape)
    op = dca.assemble_dca(t, spacing, DT)
    jop = jdca.assemble_dca(jt, spacing, DT)
    assert op.offsets == jop.offsets
    for k, off in enumerate(op.offsets):
        _assert_plane(op.coeffs[k], jop.coeffs[k], f"offset {off}")


@pytest.mark.parametrize("shape,spacing", CASES)
def test_assemble_compressed_matches_jax(shape, spacing):
    _, t, jt = _inputs(shape, seed=1)
    op = compressed.assemble_compressed_dca(t, spacing, DT)
    jop = jcomp.assemble_compressed_dca(jt, spacing, DT)
    want = _jax_compressed_planes(jop)
    assert op.planes.shape[0] == len(want) == compressed.n_planes(len(shape))
    for k in range(len(want)):
        _assert_plane(op.planes[k], want[k], f"plane {k}")
    # the compressed form applies the same operator as the stored one
    x = torch.as_tensor(np.random.default_rng(2).normal(size=shape))
    _assert_plane(op.apply(x), dca.assemble_dca(t, spacing, DT).apply(x), "apply")


@pytest.mark.parametrize("shape,spacing", CASES[:2])
def test_assemble_compressed_z_border_planes(shape, spacing):
    """The first and last z planes, each on its own: the assembly kernel
    computes them in place of the JAX package's XLA patch, so they are where
    a port goes wrong first.  The kernel's wrapper takes the plain version
    for a CPU tensor."""
    _, t, jt = _inputs(shape, seed=3)
    before = cuda_assemble_compressed_dca.launches
    op = cuda_assemble_compressed_dca(t, spacing, DT)
    want = _jax_compressed_planes(jcomp.assemble_compressed_dca(jt, spacing, DT))
    for z in (0, shape[0] - 1):
        for k in range(10):
            _assert_plane(op.planes[k, z], want[k][z], f"plane {k} at z={z}")
    assert cuda_assemble_compressed_dca.launches == before


@pytest.mark.parametrize("operator_repr", ["stored", "compressed"])
def test_hierarchy_from_numpy_round_trip(operator_repr):
    shape, spacing = (13, 12, 14), (1.0, 0.5, 2.0)
    _, t, jt = _inputs(shape, seed=4)
    jhier = jmad.build_hierarchy(jt, jlevels(shape, spacing), DT,
                                 operator_repr=operator_repr)
    got = hierarchy_from_numpy(jax.device_get(jhier))
    own = mad.build_hierarchy(t, build_level_descriptors(shape, spacing), DT,
                              operator_repr=operator_repr)
    assert len(got.operators) == len(own.operators) == 2
    for a, b in zip(got.operators, own.operators):
        assert type(a) is type(b)
        pa = a.planes if operator_repr == "compressed" else a.coeffs
        pb = b.planes if operator_repr == "compressed" else b.coeffs
        for k in range(pa.shape[0]):
            _assert_plane(pa[k], pb[k], f"plane {k}")
    assert got.solver.inv_ok and own.solver.inv_ok
    assert torch.equal(got.solver.piv, own.solver.piv)
    _assert_plane(got.solver.lu, own.solver.lu, "lu")
    _assert_plane(got.solver.inv, own.solver.inv, "inv")
