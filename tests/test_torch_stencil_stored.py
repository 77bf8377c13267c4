"""Port parity, the stored-operator and 2D stencil kernels (B12, B13): their
plain versions (what the wrappers run for a CPU tensor) against the JAX
package's ``pallas_rbgs_halfsweep`` / ``pallas_residual`` in interpret mode
on the same operators (the sizes of ``tests/test_pallas.py``), and the
dispatch: ``has_kernel`` equals JAX's ``pallas_compatible`` on every
operator of the hierarchies the kernels serve, and with ``use_kernels``
every such operator goes to its kernel's wrapper.  Float64; 1e-12 as in
``tests/test_pallas.py`` (the sums run in the same order, the JAX kernel
reads rolled and clamped neighbours where the port reads zeros, both times
a zero coefficient)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.core.stencil import StencilOperator as JStencil
from multigridanisotropicdiffusion_tpu.ops import compressed as jcomp
from multigridanisotropicdiffusion_tpu.ops import pallas_smoothers as jpallas
from multigridanisotropicdiffusion_tpu_torch.core.grids import CELL, build_level_descriptors
from multigridanisotropicdiffusion_tpu_torch.core.stencil import StencilOperator, stencil_offsets
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
from multigridanisotropicdiffusion_tpu_torch.ops import (
    compressed,
    cuda_smoothers,
    cuda_stencil2d,
    cuda_stencil_stored,
    cuda_transfer,
    dca,
    galerkin,
    smoothers,
    transfer,
)

from .conftest import make_spd_tensor_field

DT = 0.1
COUNTERS = (cuda_stencil_stored.halfsweep, cuda_stencil_stored.cuda_residual,
            cuda_stencil2d.halfsweep, cuda_stencil2d.cuda_residual)


def random_stored_op(rng, shape, radius, drop_corners=False):
    """Random diagonally dominant stored operator whose out-of-range
    coefficients are zero (the invariant the JAX kernel's clamped and
    rolled reads rely on)."""
    ndim = len(shape)
    offsets = stencil_offsets(ndim, radius, drop_corners=drop_corners)
    planes, guard = [], np.zeros(shape)
    for off in offsets:
        if not any(off):
            planes.append(None)
            continue
        p = rng.normal(size=shape) * 0.05
        for d, o in enumerate(off):
            sl = [slice(None)] * ndim
            if o > 0:
                sl[d] = slice(shape[d] - o, shape[d])
            elif o < 0:
                sl[d] = slice(0, -o)
            else:
                continue
            p[tuple(sl)] = 0.0
        planes.append(p)
        guard += np.abs(p)
    planes[offsets.index((0,) * ndim)] = guard + 1.0
    return StencilOperator(torch.as_tensor(np.stack(planes)), offsets)


def to_jax(op):
    """The port's operator as the JAX package's."""
    if isinstance(op, compressed.CompressedDCAOperator):
        p = [jnp.asarray(a.numpy()) for a in op.planes]
        nd = op.ndim
        return jcomp.CompressedDCAOperator(p[0:2 * nd:2], p[1:2 * nd:2], p[2 * nd:-1],
                                           p[-1], nd)
    return JStencil(tuple(jnp.asarray(c.numpy()) for c in op.coeffs), op.offsets)


def _check_against_pallas(op, module, rng):
    shape = op.shape
    x = rng.normal(size=shape)
    b = rng.normal(size=shape)
    xt, bt, jop = torch.as_tensor(x), torch.as_tensor(b), to_jax(op)
    before = [f.launches for f in COUNTERS]
    for color in (0, 1):
        got = module.halfsweep(op, xt, bt, color)
        want = jpallas.pallas_rbgs_halfsweep(jop, jnp.asarray(x), jnp.asarray(b),
                                             color, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12, err_msg=f"color {color}")
        # out of place: the other colour keeps the old values exactly
        keep = smoothers.parity_mask(shape) != (color == 0)
        assert torch.equal(got[keep], xt[keep])
    got = module.cuda_residual(op, xt, bt)
    want = jpallas.pallas_residual(jop, jnp.asarray(x), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert [f.launches for f in COUNTERS] == before  # CPU tensors: plain versions


@pytest.mark.parametrize("drop_corners", [True, False], ids=["19", "27"])
def test_stored_radius1_matches_pallas(rng, drop_corners):
    op = random_stored_op(rng, (6, 8, 10), 1, drop_corners)
    assert len(op.offsets) == (19 if drop_corners else 27)
    _check_against_pallas(op, cuda_stencil_stored, rng)


def test_stored_dca_matches_pallas(rng):
    """The 19-plane stored DCA operator (``operator_repr='stored'``)."""
    shape = (5, 24, 9)
    mat = make_spd_tensor_field(rng, shape, 3, hi=3.0)
    op = dca.assemble_dca(as_sym_planes(mat, shape), (1.0, 0.5, 2.0), DT)
    _check_against_pallas(op, cuda_stencil_stored, rng)


def test_stored_radius2_matches_pallas(rng):
    """Radius 2 in every dimension, x included: a full 125-plane operator
    and an exact Galerkin level (117 planes)."""
    _check_against_pallas(random_stored_op(rng, (5, 8, 6), 2), cuda_stencil_stored, rng)
    shape = (12, 12, 14)
    mat = make_spd_tensor_field(rng, shape, 3, hi=2.0)
    fine = dca.assemble_dca(as_sym_planes(mat, shape), (1.0,) * 3, DT)
    exact = galerkin.assemble_galerkin_parabolic(fine, (CELL,) * 3)
    assert exact.radius == 2 and len(exact.offsets) == 117
    _check_against_pallas(exact, cuda_stencil_stored, rng)


@pytest.mark.parametrize("shape,spacing", [((16, 24), (1.0, 0.7)), ((13, 11), (0.5, 1.0)),
                                           ((64, 32), (1.0, 1.0))])
def test_2d_compressed_matches_pallas(rng, shape, spacing):
    mat = make_spd_tensor_field(rng, shape, 2, hi=3.0)
    op = compressed.assemble_compressed_dca(as_sym_planes(mat, shape), spacing, DT)
    _check_against_pallas(op, cuda_stencil2d, rng)


def test_2d_stored_matches_pallas(rng):
    """The 9-plane stored DCA operator and a random 9-plane operator."""
    shape = (16, 16)
    mat = make_spd_tensor_field(rng, shape, 2, hi=2.0)
    _check_against_pallas(dca.assemble_dca(as_sym_planes(mat, shape), (1.0, 1.0), DT),
                          cuda_stencil2d, rng)
    _check_against_pallas(random_stored_op(rng, (15, 18), 1), cuda_stencil2d, rng)


def _hierarchy_ops(rng):
    """Every operator of the hierarchies the stencil kernels serve."""
    ops = []
    for shape in ((22, 22), (13, 12, 14)):
        mat = as_sym_planes(make_spd_tensor_field(rng, shape, len(shape), hi=2.0), shape)
        levels = build_level_descriptors(shape)
        for kw in (dict(operator_repr="compressed"), dict(operator_repr="stored"),
                   dict(coarse_operator="galerkin", operator_repr="compressed"),
                   dict(coarse_operator="galerkin", galerkin_variant="exact")):
            ops += build_hierarchy(mat, levels, DT, **kw).operators
    return ops


def test_has_kernel_matches_pallas_compatible(rng):
    ops = _hierarchy_ops(rng)
    ops += [random_stored_op(rng, (6, 5), 2), random_stored_op(rng, (5, 6, 7), 2),
            StencilOperator(torch.ones((1, 4, 4, 4)), ((0, 0, 0),))]
    kinds = set()
    for op in ops:
        want = jpallas.pallas_compatible(to_jax(op))
        assert smoothers.has_kernel(op) == want, op
        kinds.add((op.ndim, type(op).__name__, getattr(op, "radius", 1), want))
    # every form occurs: compressed 2D/3D, stored r1/r2 in 3D, stored r1 and
    # (refused) r2 in 2D
    assert {(2, "StencilOperator", 2, False), (3, "StencilOperator", 2, True),
            (2, "StencilOperator", 1, True), (3, "StencilOperator", 1, True),
            (2, "CompressedDCAOperator", 1, True),
            (3, "CompressedDCAOperator", 1, True)} <= kinds


def test_use_kernels_sends_every_kernel_operator_to_its_wrapper(rng, monkeypatch):
    """With ``use_kernels`` each operator JAX sends to Pallas reaches its
    kernel's wrapper (recorded here in place of the launch); the radius-2
    levels of a 2D exact hierarchy run the plain sweep, as JAX runs XLA."""
    calls = []

    def recorder(module, name):
        def fn(op, x, b):
            calls.append((module.__name__.rsplit(".", 1)[-1], name))
            return x
        return fn

    for module in (cuda_smoothers, cuda_stencil_stored, cuda_stencil2d):
        monkeypatch.setattr(module, "rbgs_sweep", recorder(module, "sweep"))
        monkeypatch.setattr(module, "cuda_residual", recorder(module, "residual"))
    monkeypatch.setattr(smoothers, "rb_gauss_seidel_sweep", recorder(smoothers, "sweep"))
    sweep = smoothers.make_smoother("gauss_seidel", use_kernels=True)
    resid = smoothers.make_residual(use_kernels=True)
    for op in _hierarchy_ops(rng):
        x = torch.zeros(op.shape, dtype=torch.float64)
        calls.clear()
        sweep(op, x, x)
        resid(op, x, x)
        if not smoothers.has_kernel(op):
            assert op.ndim == 2 and op.radius == 2
            assert calls == [("smoothers", "sweep")]  # and the plain residual
            continue
        want = ("cuda_stencil2d" if op.ndim == 2 else "cuda_smoothers"
                if isinstance(op, compressed.CompressedDCAOperator) else
                "cuda_stencil_stored")
        assert calls == [(want, "sweep"), (want, "residual")], op


def test_2d_transfers_take_the_plain_versions_with_use_kernels(monkeypatch):
    """The transfer kernels are 3D, as in the JAX package: 2D fields and
    ``(3, Y, X)`` stacks of 2D tensor planes route by ``len(centering)``."""
    def refuse(*args):
        raise AssertionError("a 2D transfer reached the 3D kernel's wrapper")

    monkeypatch.setattr(cuda_transfer, "cuda_restrict", refuse)
    monkeypatch.setattr(cuda_transfer, "cuda_prolong", refuse)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 16, 17)))
    cent = (CELL, "v")
    for field in (x[0], x):
        assert torch.equal(transfer.restrict(field, cent, True),
                           transfer.restrict_plain(field, cent))
        assert torch.equal(transfer.restrict_tensor(field, cent, True),
                           transfer.restrict_plain(field, cent))
        coarse = transfer.restrict_plain(field, cent)
        assert torch.equal(transfer.prolong(coarse, cent, True),
                           transfer.prolong_plain(coarse, cent))
    with pytest.raises(AssertionError, match="3D kernel"):
        transfer.restrict(torch.zeros((4, 4, 4)), (CELL,) * 3, True)
