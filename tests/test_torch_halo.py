"""Port parity of the halo-exchange ops (``parallel.halo``) and of B14's
masking, on the CPU in float64.

One spawn of 8 gloo ranks (``tests/torch_dist_workers.py``) runs every halo
op on every problem and gathers the results; each (problem, op) is then its
own test, held to 1e-12 against the JAX package's ``make_halo_*`` (the
port's ``overlap`` form against its ``overlap`` form; its Pallas form in
interpret mode, as ``tests/test_halo.py`` runs it) and against the global
sweep; 10 repeated sweeps to 1e-10.  The port's two schedules are
``torch.equal`` on every problem and on a radius-2 exact Galerkin level,
and its kernel path (overlapped) ``torch.equal`` to the blocking order.  The
kernel ops run B14's plain versions here (CPU tensors).  In one process, a
recording stub of the transport shows the order of contraction and
exchange in each mode, and that the kernel path builds no padded copy of
the block.  The masking tests hold the plain masks against a direct
evaluation of the JAX package's ``_mask_local_shells`` and
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
from multigridanisotropicdiffusion_tpu_torch.core.stencil import StencilOperator, residual
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers
from multigridanisotropicdiffusion_tpu_torch.ops.compressed import CompressedDCAOperator
from multigridanisotropicdiffusion_tpu_torch.ops.smoothers import (
    chebyshev_smoother,
    gs_halfsweep,
    jacobi_sweep,
    rb_gauss_seidel_sweep,
)
from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import GridMesh
from multigridanisotropicdiffusion_tpu_torch.utils.convert import operator_from_numpy

from .torch_dist_workers import (
    HALO_MODE_OPS,
    HALO_OPS,
    HALO_PROBLEMS,
    halo_inputs,
    halo_mode_fns,
    halo_operator,
    halo_worker,
    r2_level,
    run_ranks,
)


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
    got = dist_results[f"{problem}/{op_name}"]
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


@pytest.mark.parametrize("op_name", HALO_MODE_OPS)
@pytest.mark.parametrize("problem", list(HALO_PROBLEMS) + ["r2"])
def test_halo_modes_are_bit_for_bit(dist_results, problem, op_name):
    """The zero-halo contraction with the slabs spliced in adds the same
    terms in the same order as the exchange-first one."""
    got, want = dist_results[f"{problem}/{op_name}_overlap"], dist_results[f"{problem}/{op_name}"]
    assert np.isfinite(got).all() and np.array_equal(got, want)


_GLOBAL = {"rbgs": rb_gauss_seidel_sweep, "jacobi": jacobi_sweep,
           "chebyshev": chebyshev_smoother, "residual": residual}


@pytest.mark.parametrize("op_name", HALO_MODE_OPS)
def test_radius2_level_matches_global(dist_results, op_name):
    """Both schedules on the exact Galerkin level (halos and slabs 2 thick)
    against the port's single-process op."""
    op, x, b = r2_level()
    want = _GLOBAL[op_name](op, x, b).numpy()
    for key in (op_name, f"{op_name}_overlap"):
        np.testing.assert_allclose(dist_results[f"r2/{key}"], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("op_name", ["kernel_rbgs", "kernel_residual"])
@pytest.mark.parametrize("problem", list(HALO_PROBLEMS))
def test_kernel_path_equals_blocking_order(dist_results, problem, op_name):
    got = dist_results[f"{problem}/{op_name}"]
    assert np.array_equal(got, dist_results[f"{problem}/{op_name}_blocking"])


# ---------------------------------------------------------------------------
# the order of contraction and exchange, one process, a stub transport
# ---------------------------------------------------------------------------


def _stub_mesh():
    """Rank 0 of a (2, 1, 1) mesh, with no process group: only the stub
    transport below talks to the neighbour."""
    return GridMesh((2, 1, 1), ("x", "y", "z"), 0, (0, 0, 0), (None, None, None),
                    torch.device("cpu"))


@pytest.fixture
def recorded(monkeypatch):
    """Record the exchanges (the transport: random halos from the upper
    neighbour), the generic contractions and B14's launches, in order."""
    from multigridanisotropicdiffusion_tpu_torch.parallel import halo as H
    from multigridanisotropicdiffusion_tpu_torch.parallel import sharding

    log = []
    gen = torch.Generator().manual_seed(0)

    def transfer(lo_peer, hi_peer, to_lo, to_hi, lo_shape, hi_shape, dtype, comm, pin=False):
        log.append("exchange")
        return tuple(None if peer is None else torch.randn(shp, generator=gen, dtype=dtype)
                     for peer, shp in ((lo_peer, lo_shape), (hi_peer, hi_shape)))

    def recording(name, fn):
        def wrapped(*args):
            log.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(sharding, "_transfer", transfer)
    monkeypatch.setattr(H, "_local_offdiag", recording("contract", H._local_offdiag))
    for name in ("halfsweep_local", "cuda_residual_local"):
        monkeypatch.setattr(cuda_smoothers, name,
                            recording("kernel", getattr(cuda_smoothers, name)))
    return log


def _stub_problem(form):
    shape = (10, 5, 4)
    tensor, x, b = halo_inputs(shape, 8)
    return halo_operator(form, tensor, shape), torch.as_tensor(x), torch.as_tensor(b)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("op_name", HALO_MODE_OPS)
def test_overlap_contracts_before_the_exchange(recorded, op_name, overlap):
    """'overlap' queues the zero-halo contraction before the exchange
    starts, 'shard_map' contracts after it; each contraction of the op
    pairs with one exchange."""
    from multigridanisotropicdiffusion_tpu_torch.parallel import halo as H

    fns = halo_mode_fns(_stub_mesh(), ("x", None, None))
    op, x, b = _stub_problem("stored")
    fns[op_name + ("_overlap" if overlap else "")](op, x, b)
    pair = ["contract", "exchange"] if overlap else ["exchange", "contract"]
    n = len(recorded) // 2
    assert n >= 1 and recorded == pair * n
    assert H._op_radii(op) == (1, 1, 1)


@pytest.mark.parametrize("kind", ["sweep", "residual"])
def test_kernel_path_launches_before_the_exchange(recorded, monkeypatch, kind):
    """The kernel path launches B14 before each exchange starts, never
    calls ``exchange_halos`` and makes no tensor of the padded block's size
    (only slab-local pieces), in either mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from multigridanisotropicdiffusion_tpu_torch.parallel import halo as H

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path called exchange_halos")

    monkeypatch.setattr(H, "exchange_halos", refuse)
    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    sizes.append(tuple(t.shape))
            return out

    mesh, spec = _stub_mesh(), ("x", None, None)
    op, x, b = _stub_problem("compressed")
    # B14's plain version pads the whole block itself: the kernel on the
    # card does not, so it is left out of the count here
    monkeypatch.setattr(cuda_smoothers, "halfsweep_local_plain", lambda op, x, b, c: x.clone())
    monkeypatch.setattr(cuda_smoothers, "residual_local_plain", lambda op, x, b: x.clone())
    fn = (H.make_halo_kernel_rbgs_sweep if kind == "sweep" else H.make_halo_kernel_residual)
    with Sizes():
        fn(mesh, spec)(op, x, b)
    assert recorded == ["kernel", "exchange"] * (2 if kind == "sweep" else 1)
    padded = tuple(s + 2 for s in x.shape)
    assert sizes and padded not in sizes
    assert max(int(np.prod(s)) for s in sizes) <= x.numel()


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
    got = cuda_smoothers.mask_local_shells(op).coeffs.numpy()
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
            cuda_smoothers.halfsweep_local(op, x, b, color).numpy(),
            cuda_smoothers.halfsweep_plain(op, x, b, color).numpy())
    np.testing.assert_array_equal(cuda_smoothers.cuda_residual_local(op, x, b).numpy(),
                                  cuda_smoothers.residual_plain(op, x, b).numpy())


def test_assembled_operator_masks_to_itself():
    """On a whole domain the masking changes nothing: folding already zeroed
    exactly those coefficients (the kernels' single-device contract)."""
    shape = (6, 7, 5)
    tensor, _, _ = halo_inputs(shape, 6)
    jop = jassemble_compressed(jplanes(tensor, shape), (1.0,) * 3, 0.1)
    op = operator_from_numpy(jax.device_get(jop))
    np.testing.assert_array_equal(cuda_smoothers.mask_local_shells(op).planes.numpy(),
                                  op.planes.numpy())
