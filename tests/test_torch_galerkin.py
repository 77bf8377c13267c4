"""Port parity, Galerkin coarse operators: the port's ``ops/galerkin.py`` and
``ops/galerkin_direct.py`` against the JAX package's on the same numpy-made
operators (the shapes and tolerances of ``tests/test_galerkin.py`` and
``tests/test_galerkin_direct.py``), and the diagonal dominance of a deep
chain.  All float64 on the CPU; whole hierarchies and solves are in
``tests/test_torch_galerkin_slice.py``.

Tolerances: the direct path repeats the JAX arithmetic operation for
operation (1e-14 relative covers a summation-order difference in its row
sums); the probe path sums in another order than the JAX probe (1e-12, as
the JAX tests hold probe against direct); residual histories 1e-9 relative
down to the 1e-15 round-off floor (``tests/test_torch_mad.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.core.stencil import densify as jdensify
from multigridanisotropicdiffusion_tpu.core.symfield import as_sym_planes as jplanes
from multigridanisotropicdiffusion_tpu.ops import compressed as jcomp
from multigridanisotropicdiffusion_tpu.ops import dca as jdca
from multigridanisotropicdiffusion_tpu.ops import galerkin as jgal
from multigridanisotropicdiffusion_tpu.ops import galerkin_direct as jgd
from multigridanisotropicdiffusion_tpu_torch import MADConfig
from multigridanisotropicdiffusion_tpu_torch.core.grids import (
    CELL,
    VERTEX,
    build_level_descriptors,
)
from multigridanisotropicdiffusion_tpu_torch.core.stencil import densify
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
from multigridanisotropicdiffusion_tpu_torch.ops import compressed, dca, galerkin
from multigridanisotropicdiffusion_tpu_torch.ops import galerkin_direct as gd
from multigridanisotropicdiffusion_tpu_torch.ops.smoothers import rb_gauss_seidel_sweep

from .conftest import make_spd_tensor_field

DT = 0.1


def _fine_ops(rng, shape, form="stored", hi=3.0):
    """The port's and the JAX package's level-0 operator on one tensor."""
    ndim = len(shape)
    mat = make_spd_tensor_field(rng, shape, ndim, hi=hi)
    t, jt = as_sym_planes(mat, shape), jplanes(jnp.asarray(mat), shape)
    spacing = (1.0,) * ndim
    if form == "compressed":
        return (compressed.assemble_compressed_dca(t, spacing, DT),
                jcomp.assemble_compressed_dca(jt, spacing, DT))
    return dca.assemble_dca(t, spacing, DT), jdca.assemble_dca(jt, spacing, DT)


def _assert_same_op(op, jop, rtol, atol=0.0):
    assert op.offsets == tuple(jop.offsets)
    for k, off in enumerate(op.offsets):
        np.testing.assert_allclose(op.coeffs[k].numpy(), np.asarray(jop.coeffs[k]),
                                   rtol=rtol, atol=atol, err_msg=str(off))


@pytest.mark.parametrize("fine_n,centering", [(8, CELL), (9, VERTEX), (13, VERTEX),
                                              (16, CELL), (21, VERTEX)])
def test_pair_kernels_and_banded_specs_match_jax(fine_n, centering):
    """The pair kernels from the transfers' tap tables hold exactly the
    entries of JAX's dense pair matrices, and give its banded specs."""
    for a in (-2, -1, 0, 1, 2):
        for o in (-2, -1, 0, 1, 2):
            g = jgd.pair_matrix(fine_n, centering, a, o)
            rows = gd.pair_rows(fine_n, centering, a, o)
            dense = np.zeros_like(g)
            for j, row in enumerate(rows):
                for i, w in row:
                    dense[j, i] = w
            np.testing.assert_array_equal(dense, g)
            want = jgd.analyze_banded(g)
            got = gd.banded_pair(fine_n, centering, a, o)
            assert (got is None) == (want is None)
            if got is not None:
                assert tuple(got) == tuple(want)
                x = np.random.default_rng(5 * (a + 2) + o + 2).normal(size=(3, fine_n, 4))
                np.testing.assert_allclose(
                    gd.apply_banded(torch.as_tensor(x), got, 1).numpy(),
                    np.asarray(jgd.apply_banded(jnp.asarray(x), want, 1)),
                    rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("shape,centering,method", [
    ((9, 12), (VERTEX, CELL), "probe"),
    ((8, 9, 8), (CELL, VERTEX, CELL), "direct"),
])
def test_galerkin_matches_jax(rng, shape, centering, method):
    """``R A P`` of a stored DCA operator: offsets (the structural table)
    and planes, and in 2D the dense matrices."""
    op, jop = _fine_ops(rng, shape)
    got = galerkin.assemble_galerkin(op, centering, method=method)
    want = jgal.assemble_galerkin(jop, centering, method=method)
    _assert_same_op(got, want, rtol=1e-12 if method == "probe" else 1e-14, atol=1e-15)
    if len(shape) == 2:
        np.testing.assert_allclose(densify(got).numpy(), np.asarray(jdensify(want)),
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("shape,centering", [
    ((9, 9), (VERTEX, VERTEX)),
    ((8, 8), (CELL, CELL)),
    ((8, 9), (CELL, VERTEX)),
    ((9, 12), (VERTEX, CELL)),
    ((8, 9, 8), (CELL, VERTEX, CELL)),
    ((12, 12, 12), (CELL, CELL, CELL)),
])
def test_direct_matches_probe(rng, shape, centering):
    """The port's two assembly paths agree on the shapes the JAX package
    tests its own on (``tests/test_galerkin_direct.py``), at its 1e-12."""
    op, _ = _fine_ops(rng, shape)
    probe = galerkin.assemble_galerkin(op, centering, method="probe")
    direct = galerkin.assemble_galerkin(op, centering, method="direct")
    assert probe.offsets == direct.offsets
    torch.testing.assert_close(direct.coeffs, probe.coeffs, rtol=1e-12, atol=1e-13)


def test_parabolic_from_compressed_matches_jax(rng):
    """``I - R (I - A) P`` from the compressed level-0 operator of the fast
    configuration (its planes via ``stored_plane_terms``), by the direct
    path; the port's probe path agrees with it."""
    shape, centering = (8, 10, 8), (CELL, CELL, CELL)
    op, jop = _fine_ops(rng, shape, "compressed")
    offsets, planes = galerkin.stored_plane_terms(op)
    joffsets, jplanes_ = jgal.stored_plane_terms(jop)
    assert offsets == tuple(joffsets)
    for p, jp in zip(planes, jplanes_):
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    got = galerkin.assemble_galerkin_parabolic(op, centering, method="direct")
    want = jgal.assemble_galerkin_parabolic(jop, centering, method="direct")
    assert got.radius == 2
    _assert_same_op(got, want, rtol=1e-14, atol=1e-15)
    probe = galerkin.assemble_galerkin_parabolic(op, centering, method="probe")
    _assert_same_op(probe, want, rtol=1e-12, atol=1e-13)


def test_collapse_and_prune_match_jax(rng):
    """``collapse_to_radius1`` and ``prune_stored_operator`` on one exact
    Galerkin level, handed to both packages: same offsets and planes, row
    sums kept."""
    op, _ = _fine_ops(rng, (24, 24, 24), hi=2.0)
    exact = galerkin.assemble_galerkin_parabolic(op, (CELL,) * 3)
    jexact = jgal.StencilOperator(tuple(jnp.asarray(c.numpy()) for c in exact.coeffs),
                                  exact.offsets)
    ones = torch.ones(exact.shape, dtype=torch.float64)
    for fn, jfn in ((galerkin.collapse_to_radius1, jgal.collapse_to_radius1),
                    (lambda o: galerkin.prune_stored_operator(o, 1e-4),
                     lambda o: jgal.prune_stored_operator(o, 1e-4))):
        got, want = fn(exact), jfn(jexact)
        assert len(got.offsets) < len(exact.offsets)
        _assert_same_op(got, want, rtol=1e-15, atol=1e-16)
        np.testing.assert_allclose(got.apply(ones).numpy(), exact.apply(ones).numpy(),
                                   rtol=1e-12, atol=1e-12)
    assert galerkin.prune_stored_operator(exact, 0.0) is exact


def test_resolve_method_threshold():
    assert galerkin.DIRECT_MIN_FINE_VOXELS == jgal.DIRECT_MIN_FINE_VOXELS
    assert galerkin.PROBE_BATCH == jgal.PROBE_BATCH
    small = type("Op", (), {"shape": (63, 64, 64)})()
    big = type("Op", (), {"shape": (64, 64, 64)})()
    assert galerkin._resolve_method(small, "auto") == "probe"
    assert galerkin._resolve_method(big, "auto") == "direct"
    with pytest.raises(ValueError):
        galerkin._resolve_method(big, "dense")
    for cent, radii in (((CELL, VERTEX, CELL), (1, 2, 2)), ((VERTEX,) * 2, (2, 1))):
        assert galerkin.galerkin_offsets(cent, radii) == jgal.galerkin_offsets(cent, radii)


def test_hierarchy_stays_diagonally_dominant(rng):
    """``tests/test_galerkin.py``'s deep-chain check on the port: the exact
    parabolic hierarchy keeps sum|offdiag|/diag < 1.5 on every level and
    red-black GS contracts on each."""
    shape = (192, 192)  # six levels: 192 96 48 24 12 6
    levels = build_level_descriptors(shape, (1.0, 1.0))
    assert len(levels) == 6
    mat = make_spd_tensor_field(rng, shape, 2, hi=3.0)
    hier = build_hierarchy(as_sym_planes(mat, shape), levels, DT,
                           coarse_operator="galerkin", galerkin_variant="exact")
    for lvl, op in enumerate(hier.operators[1:], start=1):
        c = op.center_index
        absrow = sum(op.coeffs[k].abs() for k in range(len(op.offsets)) if k != c)
        dom = (absrow / op.diag).max().item()
        assert dom < 1.5, (lvl, dom)
        b = torch.as_tensor(rng.normal(size=op.shape))
        x = torch.zeros_like(b)
        r0 = (b - op.apply(x)).norm().item()
        for _ in range(4):
            x = rb_gauss_seidel_sweep(op, x, b)
        r4 = (b - op.apply(x)).norm().item()
        assert r4 < 0.8 * r0, (lvl, r4 / r0)


def test_galerkin_options_validated():
    with pytest.raises(ValueError, match="galerkin_variant"):
        MADConfig(coarse_operator="galerkin", galerkin_variant="direct")
    with pytest.raises(ValueError, match="coarse operator"):
        MADConfig(coarse_operator="algebraic")
