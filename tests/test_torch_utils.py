"""Port parity, the utilities copied from the JAX package: MetaImage IO
across both packages, checkpoint save/resume (a torch field included), the
native lexicographic-GS oracle on the port's operators, and the profiling
hooks.  Tolerances: IO round trips are exact; the native oracle agrees with
the port's stencil arithmetic to 1e-12 (float64, another summation order);
a resumed run equals the uninterrupted one to 1e-9, as
``tests/test_checkpoint.py`` holds the JAX package."""

import dataclasses

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.core.symfield import as_sym_planes as jplanes
from multigridanisotropicdiffusion_tpu.ops import dca as jdca
from multigridanisotropicdiffusion_tpu.utils import io as jio
from multigridanisotropicdiffusion_tpu.utils import native as jnative
from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
from multigridanisotropicdiffusion_tpu_torch.ops import dca, smoothers
from multigridanisotropicdiffusion_tpu_torch.utils import checkpoint, io, native, profiling

from .conftest import make_spd_tensor_field


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
def test_meta_image_round_trips_across_packages(tmp_path, compressed, dtype):
    rng = np.random.default_rng(0)
    data = (rng.uniform(0, 100, size=(5, 6, 7))).astype(dtype)
    spacing = (0.5, 0.75, 1.25)
    direction = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    kw = dict(spacing=spacing, compressed=compressed, direction=direction,
              offset=(1.0, 2.0, 3.0), center_of_rotation=(0.0, 0.5, 0.0))
    io.write_meta_image(str(tmp_path / "port.mhd"), data, **kw)
    jio.write_meta_image(str(tmp_path / "jax.mhd"), data, **kw)
    for writer in ("port", "jax"):
        for reader in (io, jio):
            img = reader.read_meta_image(str(tmp_path / f"{writer}.mhd"))
            np.testing.assert_array_equal(img.data, data)
            assert img.data.dtype == dtype and img.spacing == spacing
            np.testing.assert_array_equal(img.direction, direction)
            assert img.offset == (1.0, 2.0, 3.0)
    assert (tmp_path / "port.mhd").read_text() == \
        (tmp_path / "jax.mhd").read_text().replace("jax.", "port.")
    # `like` copies the orientation of a source image, as in the JAX package
    src = io.read_meta_image(str(tmp_path / "jax.mhd"))
    io.write_meta_image(str(tmp_path / "like.mhd"), data, like=src)
    again = jio.read_meta_image(str(tmp_path / "like.mhd"))
    assert again.spacing == spacing and again.center_of_rotation == (0.0, 0.5, 0.0)


def test_checkpoint_save_load_and_fingerprint(tmp_path):
    cfg = MADConfig(time_step=0.05, number_of_steps=3)
    field = torch.as_tensor(np.random.default_rng(1).normal(size=(8, 9)))
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, field, 2, cfg, extra={"note": "hi"})
    f2, step, extra = checkpoint.load_checkpoint(path, cfg)
    np.testing.assert_array_equal(f2, field.numpy())
    assert step == 2 and extra == {"note": "hi"}
    with pytest.raises(ValueError, match="different solver config"):
        checkpoint.load_checkpoint(path, MADConfig(time_step=0.06))


def test_resume_matches_uninterrupted(tmp_path):
    rng = np.random.default_rng(2)
    shape = (17, 16)
    tensor = make_spd_tensor_field(rng, shape, 2, hi=2.0)
    image = rng.normal(size=shape)
    cfg = MADConfig(time_step=0.05, number_of_steps=3, tolerance=1e-10)
    ref = mad_diffusion(image, tensor, config=cfg, device="cpu")
    path = str(tmp_path / "run.npz")
    checkpoint.resume_mad_diffusion(image, tensor, dataclasses.replace(cfg, number_of_steps=2),
                                    path, device="cpu")
    assert checkpoint.load_checkpoint(path)[1] == 2
    res = checkpoint.resume_mad_diffusion(image, tensor, cfg, path, device="cpu")
    np.testing.assert_allclose(res.output.numpy(), ref.output.numpy(), rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="already contains"):
        checkpoint.resume_mad_diffusion(image, tensor, cfg, path, device="cpu")


@pytest.mark.parametrize("shape", [(9, 8), (6, 7, 8)])
def test_native_oracle_on_the_port_operators(shape):
    if not native.is_available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(3)
    tensor = make_spd_tensor_field(rng, shape, len(shape), hi=3.0)
    op = dca.assemble_dca(as_sym_planes(tensor, shape), (1.0,) * len(shape), 0.1)
    jop = jdca.assemble_dca(jplanes(tensor, shape), (1.0,) * len(shape), 0.1)
    x, b = rng.normal(size=shape), rng.normal(size=shape)
    tx, tb = torch.as_tensor(x), torch.as_tensor(b)
    # the copy against the JAX package's module on the same operator
    for name, args in (("apply_stencil", (x,)), ("residual", (x, b)),
                       ("wj_sweep", (x, b)), ("gs_sweep", (x, b))):
        np.testing.assert_array_equal(getattr(native, name)(op, *args),
                                      getattr(jnative, name)(jop, *args))
    np.testing.assert_allclose(native.apply_stencil(op, tx), op.apply(tx).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(native.wj_sweep(op, tx, tb),
                               smoothers.jacobi_sweep(op, tx, tb).numpy(),
                               rtol=1e-12, atol=1e-12)
    # the lexicographic sweep is a fixed point at the solution
    x_exact = rng.normal(size=shape)
    b_exact = op.apply(torch.as_tensor(x_exact)).numpy()
    np.testing.assert_allclose(native.gs_sweep(op, x_exact, b_exact), x_exact,
                               rtol=1e-10, atol=1e-10)


def test_profiling_hooks(tmp_path):
    lines = []
    with profiling.timed("solve", sink=lines.append):
        torch.ones(4).sum()
    assert len(lines) == 1 and lines[0].startswith("[solve] ")
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones((64, 64)) @ torch.ones((64, 64))
    assert (tmp_path / "prof" / "trace.json").exists()
    assert len(prof.key_averages()) > 0
