"""Port parity of the distributed solve (``mad_diffusion(..., mesh=...)``) on
the CPU in float64.

Gloo ranks (``tests/torch_dist_workers.py``: 8 ranks where every axis is
split, 4 elsewhere, one spawn per group of three cases, so that each stays
well inside its join timeout) run every case of ``MAD_CASES`` once per test
session: shard_map and overlap, Gauss-Seidel, Jacobi and Chebyshev, V-cycle
and FMG, the kernel path (B14's and the block transfers' plain versions),
padded odd shapes in 3D and 2D, collapsed and exact (radius-2) Galerkin
levels, a ``min_local`` that agglomerates, and the bf16 defect schedule.
Five cases run again in the other halo mode and must give the same bits
and cycles.  Each case is held against the port's single-process solve and
against the JAX package's ``mad_diffusion(..., mesh=...)`` on as many
virtual CPU devices as the case has ranks (three cases here, the others in
``tests/test_torch_dist_jax.py``, so that a second test worker compiles
them): the same cycle count, residual histories to ``rtol=1e-9,
atol=1e-15`` (as ``tests/test_torch_mad.py``), outputs to 1e-10; against the
JAX package the bf16 defect schedule is held to ``tests/test_torch_mad.py``'s
bf16 bounds (cycles within one, relative L2 1e-6), since the two round their
bf16 cycles differently.
"""

import dataclasses

import jax
import numpy as np
import pytest

from multigridanisotropicdiffusion_tpu.models import mad as jmad
from multigridanisotropicdiffusion_tpu.parallel.sharding import make_grid_mesh as jmesh
from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import GridMesh

from .torch_dist_workers import HALO_TWINS, MAD_CASES, mad_spawns, shared_run, solve_inputs

#: the cases held against the JAX package's distributed solve here
JAX_MESH_CASES = ("gs_fmg_overlap", "kernels_vcycle", "padded_kernels")


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    return shared_run(tmp_path_factory, "mad", mad_spawns())


def _single(name):
    shape, _, kw, _ = MAD_CASES[name]
    tensor, image = solve_inputs(shape)
    return mad_diffusion(image, tensor, config=MADConfig(**kw), device="cpu")


def _jax_config(kw):
    kw = dict(kw)
    kw["use_pallas"] = kw.pop("use_kernels", False)
    return jmad.MADConfig(**kw)


def _assert_same_solve(got_out, got_hist, got_cycles, want_out, want_hist, want_cycles):
    n = int(want_cycles)
    assert int(got_cycles) == n and n < 100
    np.testing.assert_allclose(got_hist[:n], want_hist[:n], rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(got_out, want_out, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", list(MAD_CASES))
def test_distributed_solve_matches_single_process(dist_results, name):
    ref = _single(name)
    kw = MAD_CASES[name][2]
    assert float(dist_results[f"{name}/history"][0][int(ref.num_cycles[0]) - 1]) <= kw["tolerance"]
    _assert_same_solve(dist_results[f"{name}/output"], dist_results[f"{name}/history"][0],
                       dist_results[f"{name}/cycles"][0], ref.output.numpy(),
                       ref.residual_history[0].numpy(), ref.num_cycles[0])


@pytest.mark.parametrize("name", list(HALO_TWINS))
def test_halo_modes_solve_alike(dist_results, name):
    """The case solved again in the other halo mode ('shard_map' against
    'overlap', on the same mesh): the same bits and the same cycles."""
    twin = f"{name}/{HALO_TWINS[name]}"
    assert MADConfig(**MAD_CASES[name][2]).halo != HALO_TWINS[name]
    for key in ("output", "history", "cycles"):
        assert np.array_equal(dist_results[f"{twin}/{key}"], dist_results[f"{name}/{key}"]), key
    assert np.isfinite(dist_results[f"{twin}/output"]).all()


def jax_mesh_solve(name):
    """The JAX package's distributed solve of a case, on the first virtual
    devices, one per rank of the case."""
    shape, mshape, kw, min_local = MAD_CASES[name]
    tensor, image = solve_inputs(shape)
    mesh = jmesh(len(shape), jax.devices()[:int(np.prod(mshape))], mesh_shape=mshape)
    return jmad.mad_diffusion(image, tensor, config=_jax_config(kw), mesh=mesh,
                              min_local=min_local)


def assert_matches_jax(dist_results, name, jres):
    kw = MAD_CASES[name][2]
    if kw.get("defect_dtype") == "bfloat16":
        # the two packages round their bf16 inner cycles differently (the port
        # computes in float32 and rounds once per half-sweep): the bounds of
        # tests/test_torch_mad.py's bf16 test
        n = int(dist_results[f"{name}/cycles"][0])
        assert abs(n - int(jres.num_cycles[0])) <= 1
        assert float(dist_results[f"{name}/history"][0][n - 1]) <= kw["tolerance"]
        assert float(np.asarray(jres.final_residual[0])) <= kw["tolerance"]
        got, want = dist_results[f"{name}/output"], np.asarray(jres.output)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-6
        return
    _assert_same_solve(dist_results[f"{name}/output"], dist_results[f"{name}/history"][0],
                       dist_results[f"{name}/cycles"][0], np.asarray(jres.output),
                       np.asarray(jres.residual_history[0]), np.asarray(jres.num_cycles[0]))


@pytest.mark.parametrize("name", JAX_MESH_CASES)
def test_distributed_solve_matches_jax_mesh(dist_results, name):
    assert_matches_jax(dist_results, name, jax_mesh_solve(name))


def _one_rank_mesh(shape):
    import torch

    return GridMesh(shape, ("x", "y", "z")[:len(shape)], 0, (0,) * len(shape),
                    (None,) * len(shape), torch.device("cpu"))


def test_gspmd_is_refused_with_its_replacement_named():
    with pytest.raises(ValueError, match="overlap"):
        MADConfig(halo="gspmd")
    with pytest.raises(ValueError, match="unknown halo"):
        MADConfig(halo="ring")


def test_exact_galerkin_needs_min_local_2():
    tensor, image = solve_inputs((12, 12, 12))
    cfg = MADConfig(coarse_operator="galerkin", galerkin_variant="exact")
    with pytest.raises(ValueError, match="min_local >= 2"):
        mad_diffusion(image, tensor, config=cfg, mesh=_one_rank_mesh((2, 2, 2)),
                      min_local=1, device="cpu")


def test_matrix_free_is_refused_under_a_mesh():
    from multigridanisotropicdiffusion_tpu_torch.models.mad import _make_halo_ops

    cfg = MADConfig(operator_repr="matrix_free")
    with pytest.raises(ValueError, match="stored' or 'compressed"):
        _make_halo_ops(_one_rank_mesh((1, 1, 1)), (), cfg)


def test_one_rank_mesh_is_the_single_device_solve():
    """A mesh of one rank (no process group needed for its ops) solves
    exactly as without a mesh."""
    import torch.distributed as dist

    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import (
        initialize_multihost,
        make_grid_mesh,
    )

    assert not dist.is_initialized()
    initialize_multihost()  # a world of one, in this process
    try:
        mesh = make_grid_mesh(3, device="cpu")
        assert mesh.shape == (1, 1, 1)
        kw = dict(time_step=0.1, tolerance=1e-10, max_cycles=50)
        tensor, image = solve_inputs((12, 10, 14))
        got = mad_diffusion(image, tensor, config=MADConfig(**kw), mesh=mesh, device="cpu")
    finally:
        dist.destroy_process_group()
    want = mad_diffusion(image, tensor, config=MADConfig(**kw), device="cpu")
    _assert_same_solve(got.output.numpy(), got.residual_history[0].numpy(), got.num_cycles[0],
                       want.output.numpy(), want.residual_history[0].numpy(),
                       want.num_cycles[0])


def test_config_has_no_gspmd_default():
    assert MADConfig().halo == "overlap" and MADConfig.cuda().halo == "overlap"
    assert dataclasses.replace(MADConfig(), halo="shard_map").halo == "shard_map"
