"""Port parity of the halo-exchange ops (``parallel.halo``) and of B14's
masking, on the CPU in float64.

One spawn of 8 gloo ranks (``tests/torch_dist_workers.py``) runs every halo
op on every problem and gathers the results; each (problem, op) is then its
own test, held to 1e-12 against the JAX package's ``make_halo_*`` (with and
without ``overlap``, which the port's one exchange-then-contract path both
matches; its Pallas form in interpret mode, as ``tests/test_halo.py`` runs
it) and against the global sweep; 10 repeated sweeps to 1e-10.  The kernel ops run B14's plain
versions here (CPU tensors).  The masking tests hold the plain masks against
a direct evaluation of the JAX package's ``_mask_local_shells`` and
``_mask_local_shells_stored``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from multigridanisotropicdiffusion_tpu.core.stencil import residual as jresidual
from multigridanisotropicdiffusion_tpu.core.symfield import as_sym_planes as jplanes
from multigridanisotropicdiffusion_tpu.ops import pallas_smoothers as jps
from multigridanisotropicdiffusion_tpu.ops import smoothers as jsm
from multigridanisotropicdiffusion_tpu.ops.compressed import (
    assemble_compressed_dca as jassemble_compressed,
)
from multigridanisotropicdiffusion_tpu.ops.dca import assemble_dca as jassemble_dca
from multigridanisotropicdiffusion_tpu.parallel import halo as jhalo
from multigridanisotropicdiffusion_tpu.parallel.sharding import make_grid_mesh as jmesh
from multigridanisotropicdiffusion_tpu_torch.core.stencil import StencilOperator
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers, cuda_stencil_stored
from multigridanisotropicdiffusion_tpu_torch.ops.compressed import CompressedDCAOperator
from multigridanisotropicdiffusion_tpu_torch.ops.smoothers import gs_halfsweep
from multigridanisotropicdiffusion_tpu_torch.utils.convert import operator_from_numpy

from .torch_dist_workers import HALO_OPS, HALO_PROBLEMS, halo_inputs, halo_worker, run_ranks


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("halo")
    run_ranks(halo_worker, 8, d, str(d / "out.npz"))
    return dict(np.load(d / "out.npz"))


_JAX = {}


def _jax_problem(name):
    """The JAX package's operator, inputs, mesh and spec of a problem."""
    if name not in _JAX:
        shape, mshape, spec, form, seed = HALO_PROBLEMS[name]
        tensor, x, b = halo_inputs(shape, seed)
        assemble = jassemble_dca if form == "stored" else jassemble_compressed
        op = assemble(jplanes(tensor, shape), (1.0,) * 3, 0.1)
        mesh = jmesh(3, mesh_shape=mshape)
        _JAX[name] = (op, jnp.asarray(x), jnp.asarray(b), mesh, PartitionSpec(*spec))
    return _JAX[name]


def _jax_halo(name, op_name):
    """The JAX package's halo op and its global counterpart for a test."""
    op, x, b, mesh, spec = _jax_problem(name)
    overlap = op_name.endswith("_overlap")
    base = op_name.replace("_overlap", "")
    if base == "rbgs":
        return jhalo.make_halo_rbgs_sweep(mesh, spec, overlap), jsm.rb_gauss_seidel_sweep
    if base == "jacobi":
        return jhalo.make_halo_jacobi_sweep(mesh, spec, overlap=overlap), jsm.jacobi_sweep
    if base == "chebyshev":
        return (jhalo.make_halo_chebyshev_smoother(mesh, spec, overlap=overlap),
                jsm.chebyshev_smoother)
    if base == "residual":
        return jhalo.make_halo_residual(mesh, spec, overlap), jresidual
    if base == "kernel_rbgs":
        return (jhalo.make_halo_pallas_rbgs_sweep(mesh, spec, interpret=True),
                jsm.rb_gauss_seidel_sweep)
    assert base == "kernel_residual"
    return jhalo.make_halo_pallas_residual(mesh, spec, interpret=True), jresidual


@pytest.mark.parametrize("op_name", [o for o in HALO_OPS if not o.endswith("_x10")])
@pytest.mark.parametrize("problem", list(HALO_PROBLEMS))
def test_halo_op_matches_jax_and_global(dist_results, problem, op_name):
    got = dist_results[f"{problem}/{op_name.replace('_overlap', '')}"]
    op, x, b, _, _ = _jax_problem(problem)
    halo_fn, global_fn = _jax_halo(problem, op_name)
    want_halo = np.asarray(jax.jit(halo_fn)(op, x, b))
    want_global = np.asarray(global_fn(op, x, b))
    np.testing.assert_allclose(got, want_halo, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, want_global, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("op_name", ["rbgs_x10", "kernel_rbgs_x10"])
@pytest.mark.parametrize("problem", ["stored", "compressed", "odd_origin"])
def test_halo_repeated_sweeps_track_global(dist_results, problem, op_name):
    """10 distributed sweeps track 10 global ones (and the JAX package's
    halo sweep) to 1e-10."""
    got = dist_results[f"{problem}/{op_name}"]
    op, x, b, mesh, spec = _jax_problem(problem)
    sweep = jax.jit(jhalo.make_halo_pallas_rbgs_sweep(mesh, spec, interpret=True)
                    if op_name.startswith("kernel") else jhalo.make_halo_rbgs_sweep(mesh, spec))
    xh, xg = x, x
    for _ in range(10):
        xh = sweep(op, xh, b)
        xg = jsm.rb_gauss_seidel_sweep(op, xg, b)
    np.testing.assert_allclose(got, np.asarray(xh), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, np.asarray(xg), rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# B14's masking
# ---------------------------------------------------------------------------


def _random_compressed(shape, seed):
    """Random planes, non-zero on every border (as no assembled operator
    is), and a diagonal kept away from 0."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(10, *shape))
    planes[-1] = 4.0 + rng.uniform(size=shape)
    return planes


def _jax_mask_direct(planes):
    """``_mask_local_shells`` evaluated plane by plane over the whole block
    (one tile of the full y extent per z plane)."""
    nz, y, x = planes.shape[1:]
    out = np.empty_like(planes)
    for k in range(nz):
        coeffs = tuple(jnp.asarray(p[k:k + 1]) for p in planes[:9])
        masked = jps._mask_local_shells(coeffs, (1, y, x), nz, y, y, k, 0)
        out[:9, k] = np.stack([np.asarray(m)[0] for m in masked])
    out[9] = planes[9]
    return out


@pytest.mark.parametrize("shape", [(5, 6, 7), (1, 4, 3), (3, 3, 9)])
def test_mask_local_shells_matches_jax(shape):
    planes = _random_compressed(shape, 0)
    op = CompressedDCAOperator(torch.as_tensor(planes), 3)
    got = cuda_smoothers.mask_local_shells(op).planes.numpy()
    np.testing.assert_array_equal(got, _jax_mask_direct(planes))


def test_whole_plane_mask_differs_from_skipping_terms():
    """On a block whose planes are non-zero at its borders, the whole-plane
    rule of the mixed planes is not the same as skipping only the
    out-of-range terms of their four-term sums (the zero-padded plain
    contraction of the unmasked planes): B14 must apply the former."""
    shape = (6, 7, 8)
    rng = np.random.default_rng(1)
    op = CompressedDCAOperator(torch.as_tensor(_random_compressed(shape, 2)), 3)
    x, b = torch.as_tensor(rng.normal(size=shape)), torch.as_tensor(rng.normal(size=shape))
    masked = CompressedDCAOperator(torch.as_tensor(_jax_mask_direct(op.planes.numpy())), 3)
    for color in (0, 1):
        want = gs_halfsweep(masked, x, b, color)
        got = cuda_smoothers.halfsweep_local(op, x, b, color)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-14, atol=1e-14)
        skipped = gs_halfsweep(op, x, b, color)
        assert float((skipped - want).abs().max()) > 1e-3
    np.testing.assert_allclose(cuda_smoothers.cuda_residual_local(op, x, b).numpy(),
                               cuda_smoothers.residual_plain(masked, x, b).numpy(),
                               rtol=1e-14, atol=1e-14)


def _random_stored(shape, seed):
    from multigridanisotropicdiffusion_tpu_torch.core.stencil import stencil_offsets

    rng = np.random.default_rng(seed)
    offsets = stencil_offsets(3, 1, drop_corners=False)
    coeffs = rng.normal(size=(len(offsets), *shape))
    coeffs[offsets.index((0, 0, 0))] = 30.0 + rng.uniform(size=shape)
    return StencilOperator(torch.as_tensor(coeffs), offsets)


def test_mask_local_shells_stored_matches_jax():
    shape = (4, 5, 6)
    op = _random_stored(shape, 3)
    got = cuda_stencil_stored.mask_local_shells_stored(op).coeffs.numpy()
    c = op.center_index
    offs = [o for k, o in enumerate(op.offsets) if k != c]
    want = op.coeffs.numpy().copy()
    for k in range(shape[0]):
        coeffs = tuple(jnp.asarray(op.coeffs[i, k:k + 1].numpy())
                       for i in range(len(op.offsets)) if i != c)
        masked = jps._mask_local_shells_stored(offs, coeffs, (1, shape[1], shape[2]),
                                               shape[0], shape[1], shape[1], k, 0)
        idx = [i for i in range(len(op.offsets)) if i != c]
        for i, m in zip(idx, masked):
            want[i, k] = np.asarray(m)[0]
    np.testing.assert_array_equal(got, want)


def test_stored_local_form_is_b12_border_skip():
    """Radius 1: the shard-local masking of a stored operator equals B12's
    rule of skipping the terms whose neighbour leaves the array (the plain
    zero-padded contraction of the unmasked planes), on planes non-zero at
    every border; so B14 stored is the B12 kernel."""
    shape = (5, 6, 7)
    rng = np.random.default_rng(4)
    op = _random_stored(shape, 5)
    x, b = torch.as_tensor(rng.normal(size=shape)), torch.as_tensor(rng.normal(size=shape))
    for color in (0, 1):
        np.testing.assert_array_equal(
            cuda_stencil_stored.halfsweep_local(op, x, b, color).numpy(),
            cuda_stencil_stored.halfsweep_plain(op, x, b, color).numpy())
    np.testing.assert_array_equal(cuda_stencil_stored.cuda_residual_local(op, x, b).numpy(),
                                  cuda_stencil_stored.residual_plain(op, x, b).numpy())


def test_assembled_operator_masks_to_itself():
    """On a whole domain the masking changes nothing: folding already zeroed
    exactly those coefficients (the kernels' single-device contract)."""
    shape = (6, 7, 5)
    tensor, _, _ = halo_inputs(shape, 6)
    jop = jassemble_compressed(jplanes(tensor, shape), (1.0,) * 3, 0.1)
    op = operator_from_numpy(jax.device_get(jop))
    np.testing.assert_array_equal(cuda_smoothers.mask_local_shells(op).planes.numpy(),
                                  op.planes.numpy())
