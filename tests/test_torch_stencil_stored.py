"""Port parity, the stored-operator and 2D stencil kernels (B12, B13): their
plain versions (what ``ops.cuda_smoothers`` runs for a CPU tensor) against
the JAX package's ``pallas_rbgs_halfsweep`` / ``pallas_residual`` in
interpret mode on the same operators (the sizes of ``tests/test_pallas.py``),
and the dispatch: ``kernel_takes`` equals JAX's ``pallas_compatible`` on
every operator of the hierarchies the kernels serve (the halo's shard-local
rule too), with ``use_kernels`` every such operator reaches its form's C
entry point, and each form's launch passes the arguments of the entry
point's signature.  Float64; 1e-12 as in ``tests/test_pallas.py`` (the sums
run in the same order, the JAX kernel reads rolled and clamped neighbours
where the port reads zeros, both times a zero coefficient)."""

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
    cuda_transfer,
    dca,
    galerkin,
    smoothers,
    transfer,
)
from multigridanisotropicdiffusion_tpu_torch.utils.build import SIGNATURES

from .conftest import make_spd_tensor_field

DT = 0.1
#: each operator type and dimension's form (the key of its launch counts)
#: and the prefix of its C entry points
FORMS = {
    ("CompressedDCAOperator", 3): ("compressed", "mad_stencil"),
    ("StencilOperator", 3): ("stored", "mad_stencil_stored"),
    ("CompressedDCAOperator", 2): ("2d_compressed", "mad_stencil2d_compressed"),
    ("StencilOperator", 2): ("2d_stored", "mad_stencil2d_stored"),
}


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


def _check_against_pallas(op, rng):
    shape = op.shape
    x = rng.normal(size=shape)
    b = rng.normal(size=shape)
    xt, bt, jop = torch.as_tensor(x), torch.as_tensor(b), to_jax(op)
    before = cuda_smoothers.launches.copy()
    for color in (0, 1):
        got = cuda_smoothers.halfsweep(op, xt, bt, color)
        want = jpallas.pallas_rbgs_halfsweep(jop, jnp.asarray(x), jnp.asarray(b),
                                             color, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12, err_msg=f"color {color}")
        # out of place: the other colour keeps the old values exactly
        keep = smoothers.parity_mask(shape) != (color == 0)
        assert torch.equal(got[keep], xt[keep])
    got = cuda_smoothers.cuda_residual(op, xt, bt)
    want = jpallas.pallas_residual(jop, jnp.asarray(x), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    assert cuda_smoothers.launches == before  # CPU tensors: plain versions


@pytest.mark.parametrize("drop_corners", [True, False], ids=["19", "27"])
def test_stored_radius1_matches_pallas(rng, drop_corners):
    op = random_stored_op(rng, (6, 8, 10), 1, drop_corners)
    assert len(op.offsets) == (19 if drop_corners else 27)
    _check_against_pallas(op, rng)


def test_stored_dca_matches_pallas(rng):
    """The 19-plane stored DCA operator (``operator_repr='stored'``)."""
    shape = (5, 24, 9)
    mat = make_spd_tensor_field(rng, shape, 3, hi=3.0)
    op = dca.assemble_dca(as_sym_planes(mat, shape), (1.0, 0.5, 2.0), DT)
    _check_against_pallas(op, rng)


def test_stored_radius2_matches_pallas(rng):
    """Radius 2 in every dimension, x included: a full 125-plane operator
    and an exact Galerkin level (117 planes)."""
    _check_against_pallas(random_stored_op(rng, (5, 8, 6), 2), rng)
    shape = (12, 12, 14)
    mat = make_spd_tensor_field(rng, shape, 3, hi=2.0)
    fine = dca.assemble_dca(as_sym_planes(mat, shape), (1.0,) * 3, DT)
    exact = galerkin.assemble_galerkin_parabolic(fine, (CELL,) * 3)
    assert exact.radius == 2 and len(exact.offsets) == 117
    _check_against_pallas(exact, rng)


@pytest.mark.parametrize("shape,spacing", [((16, 24), (1.0, 0.7)), ((13, 11), (0.5, 1.0)),
                                           ((64, 32), (1.0, 1.0))])
def test_2d_compressed_matches_pallas(rng, shape, spacing):
    mat = make_spd_tensor_field(rng, shape, 2, hi=3.0)
    op = compressed.assemble_compressed_dca(as_sym_planes(mat, shape), spacing, DT)
    _check_against_pallas(op, rng)


def test_2d_stored_matches_pallas(rng):
    """The 9-plane stored DCA operator and a random 9-plane operator."""
    shape = (16, 16)
    mat = make_spd_tensor_field(rng, shape, 2, hi=2.0)
    _check_against_pallas(dca.assemble_dca(as_sym_planes(mat, shape), (1.0, 1.0), DT), rng)
    _check_against_pallas(random_stored_op(rng, (15, 18), 1), rng)


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
        assert cuda_smoothers.kernel_takes(op) == want, op
        assert cuda_smoothers.kernel_takes(op, max_radius=1) == \
            jpallas.pallas_compatible(to_jax(op), max_radius=1), op
        kinds.add((op.ndim, type(op).__name__, getattr(op, "radius", 1), want))
    # every form occurs: compressed 2D/3D, stored r1/r2 in 3D, stored r1 and
    # (refused) r2 in 2D
    assert {(2, "StencilOperator", 2, False), (3, "StencilOperator", 2, True),
            (2, "StencilOperator", 1, True), (3, "StencilOperator", 1, True),
            (2, "CompressedDCAOperator", 1, True),
            (3, "CompressedDCAOperator", 1, True)} <= kinds


def test_halo_kernel_rule_takes_the_blocks_it_took(rng):
    """The halo's kernel path takes a block when ``x.dim() == 3 and
    kernel_takes(op, max_radius=1)``, as JAX's ``_pallas_ok`` gates on
    ``pallas_compatible(op, max_radius=1)``: the blocks its own rule took
    (a 3D block of the compressed operator, or of a stored radius-1 one),
    and no 2D or radius-2 block."""
    def rule_before(op, x):
        if x.dim() != 3:
            return False
        if isinstance(op, compressed.CompressedDCAOperator):
            return True
        return isinstance(op, StencilOperator) and op.radius == 1

    ops = _hierarchy_ops(rng) + [random_stored_op(rng, (5, 6, 7), 2),
                                 random_stored_op(rng, (6, 5), 1)]
    taken = set()
    for op in ops:
        x = torch.zeros(op.shape)
        rule = x.dim() == 3 and cuda_smoothers.kernel_takes(op, max_radius=1)
        assert rule == rule_before(op, x), op
        assert rule == (x.dim() == 3 and jpallas.pallas_compatible(to_jax(op), max_radius=1))
        taken.add((op.ndim, getattr(op, "radius", 1), rule))
    assert {(3, 1, True), (3, 2, False), (2, 1, False), (2, 2, False)} <= taken


@pytest.fixture
def recorded_launches(monkeypatch):
    """Launches recorded in place of the kernels (``(entry, args)``): a
    tensor on the ``meta`` device takes the launch path, whose device
    checks and stream pass here."""
    calls = []

    def kernel(entry, dtype):
        def launch(*args):
            calls.append((entry, args))
            return 0
        return launch

    monkeypatch.setattr(cuda_smoothers, "kernel", kernel)
    monkeypatch.setattr(cuda_smoothers, "require_cuda", lambda name, *tensors: None)
    monkeypatch.setattr(cuda_smoothers, "stream_of", lambda t: 0)
    return calls


def test_use_kernels_sends_every_kernel_operator_to_its_wrapper(rng, monkeypatch,
                                                                  recorded_launches):
    """With ``use_kernels`` each operator JAX sends to Pallas reaches its
    form's C entry points through ``ops.cuda_smoothers`` and counts there;
    the radius-2 levels of a 2D exact hierarchy run the plain sweep, as JAX
    runs XLA."""
    def plain_sweep(op, x, b):
        recorded_launches.append(("plain sweep", ()))
        return x

    monkeypatch.setattr(smoothers, "rb_gauss_seidel_sweep", plain_sweep)
    sweep = smoothers.make_smoother("gauss_seidel", use_kernels=True)
    resid = smoothers.make_residual(use_kernels=True)
    for op in _hierarchy_ops(rng):
        takes = cuda_smoothers.kernel_takes(op)
        x = torch.zeros(op.shape, dtype=torch.float64, device="meta" if takes else "cpu")
        recorded_launches.clear()
        before = cuda_smoothers.launches.copy()
        sweep(op, x, x)
        resid(op, x, x)
        entries = [entry for entry, _ in recorded_launches]
        if not takes:
            assert op.ndim == 2 and op.radius == 2
            assert entries == ["plain sweep"]  # and the plain residual
            continue
        form, prefix = FORMS[type(op).__name__, op.ndim]
        # the 3D compressed operator's sweep is one launch (B17), the other
        # forms' two half-sweeps
        name, count = ("sweep", 1) if form == "compressed" else ("halfsweep", 2)
        assert entries == [f"{prefix}_{name}"] * count + [f"{prefix}_residual"], op
        assert cuda_smoothers.launches - before == {(form, name): count,
                                                    (form, "residual"): 1}


def _form_ops(rng):
    """One operator of each form: 3D compressed, 3D stored (radius 1 and
    2), 2D compressed, 2D stored."""
    mat3 = as_sym_planes(make_spd_tensor_field(rng, (5, 6, 7), 3, hi=2.0), (5, 6, 7))
    mat2 = as_sym_planes(make_spd_tensor_field(rng, (6, 7), 2, hi=2.0), (6, 7))
    return [compressed.assemble_compressed_dca(mat3, (1.0,) * 3, DT),
            dca.assemble_dca(mat3, (1.0,) * 3, DT), random_stored_op(rng, (5, 6, 7), 2),
            compressed.assemble_compressed_dca(mat2, (1.0,) * 2, DT),
            dca.assemble_dca(mat2, (1.0,) * 2, DT)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_launch_arguments_per_form(rng, recorded_launches, dtype):
    """Each form's launch, argument for argument: the planes, x, b and out
    pointers, the shape, the form's plan (planes per block of the 3D
    compressed launch geometry; a stored operator's tap plan, its length and
    centre index), the colour of a half-sweep and the stream, as many as
    the entry point's signature has.  The shard-local forms: the compressed
    operator's ``_local`` kernels, a radius-1 stored operator's B12 kernel."""
    for op in _form_ops(rng):
        op = op.astype(dtype)
        form, prefix = FORMS[type(op).__name__, op.ndim]
        x = torch.zeros(op.shape, dtype=dtype, device="meta")
        if form.endswith("compressed"):
            ptr = op.planes.data_ptr()
            plan = (cuda_smoothers.launch_geometry(op.shape, dtype)[0],) if op.ndim == 3 else ()
        else:
            ptr, taps = op.coeffs.data_ptr(), cuda_smoothers.tap_plan(op.offsets)
            plan = (taps.ctypes.data, len(op.offsets) - 1, op.center_index)
        head = (ptr, 0, 0, 0, *op.shape, *plan)
        passes = [("halfsweep", lambda c: cuda_smoothers.halfsweep(op, x, x, c)),
                  ("residual", lambda: cuda_smoothers.cuda_residual(op, x, x))]
        if form == "compressed":
            # the fused sweep (B17): the fused plan's planes per block
            recorded_launches.clear()
            assert cuda_smoothers.rbgs_sweep(op, x, x).shape == x.shape
            zrun = cuda_smoothers.launch_geometry(op.shape, dtype, sweep=True)[0]
            want = (ptr, 0, 0, 0, *op.shape, zrun, 0)
            assert recorded_launches == [(f"{prefix}_sweep", want)]
            assert len(want) == len(SIGNATURES[f"{prefix}_sweep"])
        if op.ndim == 3 and getattr(op, "radius", 1) == 1:
            passes += [("halfsweep_local",
                        lambda c: cuda_smoothers.halfsweep_local(op, x, x, c)),
                       ("residual_local", lambda: cuda_smoothers.cuda_residual_local(op, x, x))]
        for name, run in passes:
            entry = f"{prefix}_{name}" if form == "compressed" else \
                f"{prefix}_{name.removesuffix('_local')}"
            colors = (0, 1) if name.startswith("halfsweep") else (None,)
            for color in colors:
                recorded_launches.clear()
                out = run(color) if color is not None else run()
                assert out.shape == x.shape and out.dtype == dtype
                want = head + ((color,) if color is not None else ()) + (0,)
                assert recorded_launches == [(entry, want)], (form, name)
                assert len(want) == len(SIGNATURES[entry])


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
