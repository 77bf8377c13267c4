"""Port parity of the distributed VED (``ved(..., mesh=...)``), the façades'
``set_mesh`` and ``mad_diffusion_verbose`` with a mesh, on the CPU in
float64.

Three spawns of 8 gloo ranks (``tests/torch_dist_workers.py``, once per test
session) run the cases: the z-slab pipeline in ``smooth_fd`` on (8, 1, 1)
and on a (2, 2, 2) mesh through the kernels' plain versions (the main path),
in ``gaussian_derivative`` mode, and a shape whose z extent does not split
into slabs (the whole-volume pipeline on every rank).  Each is held against
the port's single-process ``ved`` (vesselness and tensor to 1e-12, output
to 1e-10), and against the JAX package's ``ved(..., mesh=...)`` (the
(8, 1, 1) case here, the others in ``tests/test_torch_dist_jax.py``): to
the same bounds where the JAX package runs its XLA pipeline
(``gaussian_derivative``, and shapes that do not split into slabs); its
``smooth_fd`` mesh pipeline runs the Pallas kernels (interpret mode here),
whose polynomial arccos (A&S 4.4.46, ~2e-8 absolute) moves the eigenvalues,
so there the bounds are that polynomial's (output 1e-8, vesselness 2e-8,
tensor 1e-7 absolute, against 2.5e-9, 4.2e-9 and 1.7e-8 measured), and the
same volume through the JAX package's single-device XLA pipeline
(``jnp.arccos``) is held to 1e-10 / 1e-12.  The trace is held line for line
against the JAX package's distributed trace.
"""

import re

import jax
import numpy as np
import pytest

from multigridanisotropicdiffusion_tpu.models import ved as jved
from multigridanisotropicdiffusion_tpu.models.mad import MADConfig as JMADConfig
from multigridanisotropicdiffusion_tpu.models.trace import (
    mad_diffusion_verbose as jmad_diffusion_verbose,
)
from multigridanisotropicdiffusion_tpu.parallel.sharding import make_grid_mesh as jmesh
from multigridanisotropicdiffusion_tpu_torch import MADConfig, VEDConfig, mad_diffusion, ved
from multigridanisotropicdiffusion_tpu_torch.models.trace import mad_diffusion_verbose

from .torch_dist_workers import (
    MAD_CASES,
    TRACE_CASE,
    VED_BASE,
    VED_CASES,
    shared_run,
    solve_inputs,
    tube_volume,
    ved_spawns,
)

#: cases whose JAX mesh pipeline runs the Pallas kernels (polynomial arccos)
JAX_PALLAS_PIPELINE = ("smooth_fd_zslabs", "smooth_fd_kernels")


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    return shared_run(tmp_path_factory, "ved", ved_spawns())


def _jax_config(kw):
    kw = dict(kw)
    kw["use_pallas"] = kw.pop("use_kernels", False)
    return jved.VEDConfig(**VED_BASE, **kw)


def jax_mesh_ved(name):
    """The JAX package's distributed VED of a case."""
    shape, mshape, kw = VED_CASES[name]
    mesh = jmesh(3, jax.devices()[:int(np.prod(mshape))], mesh_shape=mshape)
    return jved.ved(tube_volume(shape), config=_jax_config(kw), mesh=mesh, min_local=4)


def assert_ved_matches(dist_results, name, want, polynomial_arccos):
    """The distributed VED against a JAX package run: to the same-process
    bounds, or to the polynomial arccos's where the JAX side ran it."""
    tol = (dict(output=1e-8, vesselness=2e-8, tensor=1e-7) if polynomial_arccos
           else dict(output=1e-10, vesselness=1e-12, tensor=1e-12))
    rtol = 0.0 if polynomial_arccos else None
    for key, value in (("output", want.output), ("vesselness", want.vesselness),
                       ("tensor", np.stack(want.tensor))):
        np.testing.assert_allclose(dist_results[f"{name}/{key}"], np.asarray(value),
                                   rtol=tol[key] if rtol is None else rtol, atol=tol[key])


def _single_ved(name):
    shape, _, kw = VED_CASES[name]
    return ved(tube_volume(shape), config=VEDConfig(**VED_BASE, **kw), device="cpu")


@pytest.mark.parametrize("name", list(VED_CASES))
def test_distributed_ved_matches_single_process(dist_results, name):
    ref = _single_ved(name)
    np.testing.assert_allclose(dist_results[f"{name}/vesselness"], ref.vesselness.numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dist_results[f"{name}/tensor"], ref.tensor.numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dist_results[f"{name}/output"], ref.output.numpy(),
                               rtol=1e-10, atol=1e-10)
    assert float(dist_results[f"{name}/relres"][-1]) <= VED_BASE["tolerance"]


def test_distributed_ved_matches_jax_mesh(dist_results):
    name = "smooth_fd_zslabs"
    assert name in JAX_PALLAS_PIPELINE
    assert_ved_matches(dist_results, name, jax_mesh_ved(name), polynomial_arccos=True)
    # the gap is the polynomial's: the JAX package's single-device XLA
    # pipeline (jnp.arccos) on the same volume agrees to the tight bounds
    shape, _, kw = VED_CASES[name]
    assert_ved_matches(dist_results, name, jved.ved(tube_volume(shape), config=_jax_config(kw)),
                       polynomial_arccos=False)


def test_ved_facade_set_mesh_returns_the_whole_volume(dist_results):
    ref = _single_ved("smooth_fd_zslabs")
    got = dist_results["facade_ved/output"]
    assert got.shape == tuple(ref.output.shape)
    np.testing.assert_allclose(got, ref.output.numpy(), rtol=1e-10, atol=1e-10)


def test_mad_facade_set_mesh_returns_the_whole_volume(dist_results):
    shape, _, kw, _ = MAD_CASES["gs_fmg_overlap"]
    tensor, image = solve_inputs(shape)
    ref = mad_diffusion(image, tensor, config=MADConfig(**kw), device="cpu")
    got = dist_results["facade_mad/output"]
    assert got.shape == shape
    np.testing.assert_allclose(got, ref.output.numpy(), rtol=1e-10, atol=1e-10)


_NUMBER = re.compile(r"= (\S+)$")


def _split(line):
    m = _NUMBER.search(line)
    return (line[:m.start()], float(m.group(1))) if m else (line, None)


def test_verbose_trace_with_mesh_matches_jax_line_for_line(dist_results):
    """The distributed trace prints the JAX package's distributed trace: the
    same lines, each residual to 1e-9 relative (1e-14 absolute: the direct
    solver's relative residual sits at the float64 floor)."""
    shape, mshape, kw, min_local = TRACE_CASE
    tensor, image = solve_inputs(shape)
    jlines = []
    jout, _ = jmad_diffusion_verbose(image, tensor, config=JMADConfig(halo="overlap", **kw),
                                     print_fn=jlines.append,
                                     mesh=jmesh(3, mesh_shape=mshape), min_local=min_local)
    lines = [str(s) for s in dist_results["trace_lines"]]
    assert len(lines) == len(jlines) > 10
    for got, want in zip(lines, jlines):
        (gt, gv), (wt, wv) = _split(got), _split(want)
        assert gt == wt
        if wv is not None:
            np.testing.assert_allclose(gv, wv, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(dist_results["trace/output"], np.asarray(jout),
                               rtol=1e-10, atol=1e-10)


def test_verbose_trace_refuses_padded_volumes():
    import torch

    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import GridMesh

    mesh = GridMesh((2, 2, 2), ("x", "y", "z"), 0, (0, 0, 0), (None,) * 3,
                    torch.device("cpu"))
    tensor, image = solve_inputs((17, 16, 16))
    with pytest.raises(ValueError, match="pad-to-divisible"):
        mad_diffusion_verbose(image, tensor, mesh=mesh, min_local=4, device="cpu",
                              print_fn=lambda s: None)
