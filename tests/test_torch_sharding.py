"""The port's mesh layer (``parallel.sharding``, ``parallel.padding``)
against the JAX package's, the two-process launch recipe of
``tests/test_multihost.py``, and the ``halo`` mapping of the config
converters.  CPU, float64."""

import jax
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.models.mad import MADConfig as JMADConfig
from multigridanisotropicdiffusion_tpu.models.ved import VEDConfig as JVEDConfig
from multigridanisotropicdiffusion_tpu.parallel import padding as jpadding
from multigridanisotropicdiffusion_tpu.parallel import sharding as jsharding
from multigridanisotropicdiffusion_tpu_torch import MADConfig, VEDConfig, mad_diffusion, ved
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.ops.compressed import assemble_compressed_dca
from multigridanisotropicdiffusion_tpu_torch.ops.dca import assemble_dca
from multigridanisotropicdiffusion_tpu_torch.parallel import padding, sharding
from multigridanisotropicdiffusion_tpu_torch.utils.convert import (
    mad_config_from_jax,
    ved_config_from_jax,
)

from .torch_dist_workers import (
    VED_BASE,
    multihost_worker,
    run_ranks,
    solve_inputs,
    spd_tensor_field,
    tube_volume,
)


def _mesh(shape, coords=None):
    """A port mesh seen from the rank at ``coords`` (no process group: the
    layout functions need none)."""
    coords = coords or (0,) * len(shape)
    return sharding.GridMesh(tuple(shape), ("x", "y", "z")[:len(shape)],
                             int(np.ravel_multi_index(coords, shape)), tuple(coords),
                             (None,) * len(shape), torch.device("cpu"))


@pytest.mark.parametrize("n,ndim", [(8, 2), (8, 3), (4, 2), (1, 2), (6, 2), (12, 3), (2, 3),
                                    (7, 3)])
def test_factorize_devices_matches_jax(n, ndim):
    assert sharding.factorize_devices(n, ndim) == jsharding.factorize_devices(n, ndim)


LAYOUTS = [
    ((4, 2), (64, 64), 8), ((4, 2), (16, 16), 8), ((4, 2), (8, 8), 8),
    ((4, 2), (65, 48), 4), ((4, 2), (9, 48), 4), ((2, 2, 2), (24, 25, 24), 4),
    ((2, 2, 2), (17, 21, 18), 4), ((4, 2, 1), (20, 16, 12), 4), ((8, 1, 1), (513, 7, 9), 8),
    ((2, 2, 2), (6, 6, 6), 2),
]


@pytest.mark.parametrize("mshape,shape,min_local", LAYOUTS)
def test_level_spec_and_padded_shape_match_jax(mshape, shape, min_local):
    jmesh = jsharding.make_grid_mesh(len(mshape), mesh_shape=mshape)
    mesh = _mesh(mshape)
    jspec = tuple(jsharding.level_spec(jmesh, shape, min_local))
    assert sharding.level_spec(mesh, shape, min_local) == jspec + (None,) * (len(shape) - len(jspec))
    pshape = padding.padded_level_shape(mesh, shape, min_local)
    assert pshape == jpadding.padded_level_shape(jmesh, shape, min_local)
    jpspec = tuple(jsharding.level_spec(jmesh, pshape, min_local))
    assert sharding.level_spec(mesh, pshape, min_local) == jpspec + (None,) * (
        len(shape) - len(jpspec))


@pytest.mark.parametrize("mshape,shape", [((2, 2, 2), (17, 21, 18)), ((4, 2), (65, 48)),
                                          ((8, 1, 1), (20, 5, 3))])
def test_output_blocks_tile_the_volume(mshape, shape):
    """The output layout's blocks of every rank cover the volume once (the
    last ones may be short or empty), inside each rank's level block."""
    cover = np.zeros(shape, int)
    pshape = padding.padded_level_shape(_mesh(mshape), shape, 4)
    for r in range(int(np.prod(mshape))):
        coords = tuple(int(c) for c in np.unravel_index(r, mshape))
        mesh = _mesh(mshape, coords)
        spec = sharding.level_spec(mesh, pshape, 4)
        box = [sharding.output_range(mesh, n, d) for d, n in enumerate(shape)]
        cover[tuple(slice(*b) for b in box)] += 1
        for d, (lo, hi) in enumerate(box):
            b0, b1 = sharding.block_range(mesh, spec, pshape, d)
            assert hi == lo or b0 <= lo < hi <= b1
    assert (cover == 1).all()


def test_pad_operator_identity_rows():
    """Pad rows are identity equations: the padded operator reproduces the
    original apply on the true cells and gives 0 on the pad (the JAX
    package's ``test_pad_operator_identity_rows``)."""
    rng = np.random.default_rng(0)
    shape, pshape = (9, 11), (12, 12)
    planes = as_sym_planes(spd_tensor_field(rng, shape, 2, hi=3.0), shape,
                           dtype=torch.float64, device="cpu")
    x = torch.as_tensor(rng.normal(size=shape))
    for op in (assemble_dca(planes, (1.0, 1.0), 0.1),
               assemble_compressed_dca(planes, (1.0, 1.0), 0.1)):
        pop = padding.pad_operator(op, pshape)
        y = pop.apply(padding.pad_field(x, pshape))
        np.testing.assert_allclose(padding.crop_field(y, shape).numpy(), op.apply(x).numpy(),
                                   rtol=1e-13, atol=1e-13)
        pad = np.ones(pshape, bool)
        pad[:shape[0], :shape[1]] = False
        assert (y.numpy()[pad] == 0.0).all()


# ---------------------------------------------------------------------------
# two processes through initialize_multihost (tests/test_multihost.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    run_ranks(multihost_worker, 2, d, str(d / "out.npz"), env={"LOCAL_WORLD_SIZE": "1"})
    return dict(np.load(d / "out.npz"))


def test_two_process_mesh_splits_the_first_axis(multihost):
    assert int(multihost["world"]) == 2
    assert tuple(multihost["mesh_shape"]) == (2, 1, 1)


@pytest.mark.parametrize("halo", ["shard_map", "overlap"])
def test_two_process_solve_matches_single(multihost, halo):
    tensor, image = solve_inputs((32, 16, 16))
    ref = mad_diffusion(image, tensor, device="cpu",
                        config=MADConfig(time_step=0.1, tolerance=1e-9, max_cycles=40))
    assert float(multihost[f"{halo}/relres"][0]) <= 1e-9
    assert int(multihost[f"{halo}/cycles"][0]) == int(ref.num_cycles[0])
    assert np.abs(multihost[f"{halo}/output"] - ref.output.numpy()).max() < 1e-9


def test_two_process_ved_matches_single(multihost):
    ref = ved(tube_volume((18, 16, 16)), config=VEDConfig(**VED_BASE), device="cpu")
    assert float(multihost["ved/relres"][-1]) <= 1e-8
    out = ref.output.numpy()
    assert np.abs(multihost["ved/output"] - out).max() < 1e-10 * max(np.abs(out).max(), 1.0)


# ---------------------------------------------------------------------------
# the halo mapping of the config converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_halo,port_halo", [("gspmd", "overlap"), ("shard_map", "shard_map"),
                                                ("overlap", "overlap")])
def test_mad_config_from_jax_maps_halo(jax_halo, port_halo):
    cfg = mad_config_from_jax(JMADConfig(halo=jax_halo, use_pallas=True))
    assert cfg.halo == port_halo and cfg.use_kernels


@pytest.mark.parametrize("jax_halo,port_halo", [("gspmd", "overlap"), ("shard_map", "shard_map"),
                                                ("overlap", "overlap")])
def test_ved_config_from_jax_maps_halo(jax_halo, port_halo):
    cfg = ved_config_from_jax(JVEDConfig(halo=jax_halo))
    assert cfg.halo == port_halo and cfg.mad_config().halo == port_halo


def test_tpu_presets_map_to_the_cuda_presets():
    assert mad_config_from_jax(JMADConfig.tpu()) == MADConfig.cuda()
    assert ved_config_from_jax(JVEDConfig.tpu()) == VEDConfig.cuda()
    assert jax.devices()  # the JAX side ran on its CPU devices
