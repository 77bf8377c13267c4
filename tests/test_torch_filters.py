"""Port parity, the ITK-style façades (``models/filters.py``): the same
setters, chaining and defaults as the JAX package's, delegating to the
port's ``mad_diffusion`` and ``ved`` (``tests/test_filters.py`` mirrored).

Tolerances: a façade equals the port's functional call exactly (the same
computation); against the JAX façade, 1e-10 relative L2 in float64, as
``tests/test_torch_mad.py`` holds the solve."""

import dataclasses

import numpy as np
import pytest
import torch

import multigridanisotropicdiffusion_tpu as jmadt
from multigridanisotropicdiffusion_tpu.models import filters as jfilters
from multigridanisotropicdiffusion_tpu_torch import (
    FMG,
    MADConfig,
    MultigridAnisotropicDiffusionImageFilter,
    VEDConfig,
    VEDMultigridImageFilter,
    mad_diffusion,
    ved,
)
from multigridanisotropicdiffusion_tpu_torch.utils.convert import (
    mad_config_from_jax,
    ved_config_from_jax,
)


def _rel_l2(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mad_inputs():
    rng = np.random.default_rng(0)
    img = rng.uniform(0.0, 255.0, size=(33, 40))
    tensor = np.zeros((*img.shape, 2, 2))
    tensor[..., 0, 0] = 50.0
    tensor[..., 1, 1] = 30.0
    return img, tensor


def _configure_mad(f, img, tensor):
    return (f.set_input(img).set_diffusion_tensor(tensor).set_time_step(0.1)
            .set_tolerance(1e-10).set_max_cycles(100).set_iterations_per_grid(2))


def test_mad_filter_matches_functional_and_jax():
    img, tensor = _mad_inputs()
    f = _configure_mad(MultigridAnisotropicDiffusionImageFilter(device="cpu"), img, tensor)
    out = f.get_output()  # implicit update()
    cfg = MADConfig(time_step=0.1, tolerance=1e-10, max_cycles=100, iterations_per_grid=2)
    assert f.get_config() == cfg
    ref = mad_diffusion(img, tensor, config=cfg, device="cpu")
    torch.testing.assert_close(out, ref.output, rtol=0, atol=0)
    assert float(f.get_result().final_residual[0]) <= 1e-10

    jf = _configure_mad(jfilters.MultigridAnisotropicDiffusionImageFilter(), img, tensor)
    assert mad_config_from_jax(jf.get_config()) == f.get_config()
    assert _rel_l2(out, jf.get_output()) <= 1e-10
    assert int(f.get_result().num_cycles[0]) == int(jf.get_result().num_cycles[0])

    # the setter surface chains like the reference's parameter set
    f.set_cycle(FMG).set_number_of_steps(2).set_verbose(False)
    assert f.get_config().cycle == FMG and f.get_config().number_of_steps == 2


def test_ved_filter_matches_functional_and_jax():
    vol = np.random.default_rng(1).uniform(0.0, 100.0, size=(12, 14, 12))

    def configure(f):
        return (f.set_spacing((1.0, 1.0, 1.0)).set_input(vol).set_scales([0.5, 1.0])
                .set_omega(1.5).set_diffusion_iterations(1).set_tolerance(1e-8))

    f = configure(VEDMultigridImageFilter(device="cpu"))
    out = f.get_output()
    cfg = VEDConfig(scales=(0.5, 1.0), omega=1.5, diffusion_iterations=1, tolerance=1e-8)
    assert f.get_config() == cfg
    ref = ved(vol, spacing=(1.0, 1.0, 1.0), config=cfg, device="cpu")
    torch.testing.assert_close(out, ref.output, rtol=0, atol=0)

    jf = configure(jfilters.VEDMultigridImageFilter())
    assert ved_config_from_jax(jf.get_config()) == f.get_config()
    assert _rel_l2(out, jf.get_output()) <= 1e-10
    assert f.get_config().alpha == 0.5  # reference ctor default


@pytest.mark.parametrize("smoother", ["gauss_seidel", "weighted_jacobi", "chebyshev"])
def test_defaults_match_jax_field_by_field(smoother):
    """The reference ctor defaults, through ``convert``: the JAX façades
    keep ``use_pallas`` off, the port's ``use_kernels``."""
    mad = MultigridAnisotropicDiffusionImageFilter(smoother).get_config()
    jmad = jfilters.MultigridAnisotropicDiffusionImageFilter(smoother).get_config()
    assert mad == mad_config_from_jax(jmad)
    for f in dataclasses.fields(MADConfig):
        src = "use_pallas" if f.name == "use_kernels" else f.name
        assert getattr(mad, f.name) == getattr(jmad, src), f.name
    assert not mad.use_kernels
    v = VEDMultigridImageFilter(smoother).get_config()
    jv = jfilters.VEDMultigridImageFilter(smoother).get_config()
    assert v == ved_config_from_jax(jv)
    assert not v.use_kernels and v.smoother == smoother
    assert v.mad_config() == mad_config_from_jax(jv.mad_config())


def test_every_setter_sets_what_jax_sets():
    """Each setter, applied to both façades, gives the same config."""
    mad_calls = [("set_cycle", FMG), ("set_time_step", 0.05), ("set_number_of_steps", 3),
                 ("set_iterations_per_grid", 3), ("set_max_cycles", 7),
                 ("set_tolerance", 1e-7), ("set_verbose", True)]
    f, jf = (MultigridAnisotropicDiffusionImageFilter(),
             jfilters.MultigridAnisotropicDiffusionImageFilter())
    for name, value in mad_calls:
        assert getattr(f, name)(value) is f
        getattr(jf, name)(value)
    assert f.get_config() == mad_config_from_jax(jf.get_config())
    ved_calls = [("set_scales", [1.0, 3.0]), ("set_alpha", 0.4), ("set_beta", 0.6),
                 ("set_gamma", 4.0), ("set_epsilon", 0.02), ("set_omega", 3.0),
                 ("set_sensitivity", 8.0), ("set_iterations", 2),
                 ("set_diffusion_iterations", 3), ("set_cycle", FMG),
                 ("set_time_step", 0.2), ("set_tolerance", 1e-5),
                 ("set_diffusion_iterations_per_grid", 1)]
    v, jv = VEDMultigridImageFilter(), jfilters.VEDMultigridImageFilter()
    for name, value in ved_calls:
        assert getattr(v, name)(value) is v
        getattr(jv, name)(value)
    assert v.get_config() == ved_config_from_jax(jv.get_config())
    cfg = VEDConfig.cuda(hessian_mode="gaussian_derivative")
    assert v.set_config(cfg).get_config() is cfg


def test_refusals_and_device(monkeypatch):
    with pytest.raises(ValueError, match="set_input"):
        MultigridAnisotropicDiffusionImageFilter().update()
    with pytest.raises(ValueError, match="set_input"):
        VEDMultigridImageFilter().update()
    for f in (MultigridAnisotropicDiffusionImageFilter(), VEDMultigridImageFilter()):
        with pytest.raises(NotImplementedError, match="A11"):
            f.set_mesh(object())
    # no device argument: the card, and no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, tensor = _mad_inputs()
    f = MultigridAnisotropicDiffusionImageFilter().set_input(img).set_diffusion_tensor(tensor)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        f.update()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VEDMultigridImageFilter().set_input(np.zeros((8, 8, 8))).update()
    assert jmadt.MADConfig().smoother == MADConfig().smoother
