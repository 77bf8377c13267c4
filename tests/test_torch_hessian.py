"""Port parity, ``ops/hessian.py`` and the convolution kernels' plain
versions: against the JAX package's XLA functions and its Pallas kernels in
interpret mode (float64 on the CPU), as ``tests/test_pallas_conv.py`` runs
them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.ops import hessian as jhessian
from multigridanisotropicdiffusion_tpu.ops.pallas_conv import (
    pallas_conv_yx,
    pallas_conv_z,
)
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv, hessian

SPACING = (0.9, 1.0, 1.2)


def _field(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape) * 10.0


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("sigma,spacing", [(0.3, 1.0), (1.3, 1.0), (2.0, 0.25)])
def test_kernels_1d_and_radius_match_jax(sigma, spacing):
    assert hessian.kernel_radius(sigma, spacing) == jhessian.kernel_radius(sigma, spacing)
    for k, jk in zip(hessian.gaussian_kernels_1d(sigma, spacing),
                     jhessian.gaussian_kernels_1d(sigma, spacing)):
        np.testing.assert_array_equal(k, jk)
    assert hessian.fd_factors(sigma, SPACING) == jhessian.fd_factors(sigma, SPACING)


@pytest.mark.parametrize("axis,valid", [(0, False), (1, False), (2, False),
                                        (0, True)])
def test_conv_axis_matches_jax(axis, valid):
    g = hessian.gaussian_kernels_1d(1.3, 1.0)[1]
    shape = [9, 10, 11]
    if valid:
        shape[0] += len(g) - 1
    u = _field(tuple(shape), axis)
    got = hessian._conv_axis(torch.as_tensor(u), g, axis, valid=valid)
    want = jhessian._conv_axis(jnp.asarray(u), g, axis, valid=valid)
    _close(got, want)


def test_conv_z_plain_matches_the_pallas_kernel():
    """B6's plain version against ``pallas_conv_z(valid=True)`` (and edge
    mode) in interpret mode, including zero-padded taps."""
    g = hessian.gaussian_kernels_1d(1.0, 1.0)[0]
    gp = np.pad(g, (3, 3))
    r = (len(gp) - 1) // 2
    u = _field((14 + 2 * r, 16, 128), 1)
    want = pallas_conv_z(jnp.asarray(u), gp, valid=True, interpret=True)
    _close(cuda_conv.conv_z(torch.as_tensor(u), gp, valid=True), want)
    u = _field((12, 16, 128), 2)
    want = pallas_conv_z(jnp.asarray(u), g, valid=False, interpret=True)
    _close(cuda_conv.conv_z(torch.as_tensor(u), g), want)


def test_conv_yx_plain_matches_the_pallas_kernel():
    gy = hessian.gaussian_kernels_1d(1.3, 0.9)[0]
    gx = hessian.gaussian_kernels_1d(0.775, 1.2)[0]
    u = _field((6, 16, 128), 3)
    want = pallas_conv_yx(jnp.asarray(u), gy, gx, interpret=True)
    _close(cuda_conv.conv_yx(torch.as_tensor(u), gy, gx), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_plain_accumulates_in_float32(dtype):
    """16-bit storage sums the taps in float32 and rounds once; the fused y+x
    pass rounds once, after x."""
    g = hessian.gaussian_kernels_1d(2.0, 1.0)[0]
    u = torch.as_tensor(_field((5, 20, 21), 4)).to(dtype)
    got = cuda_conv.conv_yx(u, g, g)
    want = cuda_conv.conv_axis_plain(
        cuda_conv.conv_axis_plain(u.float(), g, 1), g, 2).to(dtype)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("z_valid_radius", [None, 7])
def test_smoothed_field_valid_z_matches_jax(z_valid_radius):
    u = _field((10, 11, 12), 5)
    if z_valid_radius is not None:
        u = np.pad(u, ((z_valid_radius, z_valid_radius), (0, 0), (0, 0)),
                   mode="edge")
    for use_kernels in (False, True):
        got = hessian.smoothed_field_valid_z(torch.as_tensor(u), 1.245, SPACING,
                                             z_valid_radius, use_kernels=use_kernels)
        want = jhessian.smoothed_field_valid_z(jnp.asarray(u), 1.245, SPACING,
                                               z_valid_radius)
        _close(got, want)


@pytest.mark.parametrize("mode", ["gaussian_derivative", "smooth_fd"])
@pytest.mark.parametrize("z_valid_radius", [None, 8])
def test_hessian_matches_jax(mode, z_valid_radius):
    u = _field((9, 10, 11), 6)
    if z_valid_radius is not None:
        u = np.pad(u, ((z_valid_radius, z_valid_radius), (0, 0), (0, 0)),
                   mode="edge")
    got = hessian.hessian(torch.as_tensor(u), 1.245, SPACING,
                          z_valid_radius=z_valid_radius, mode=mode)
    want = jhessian.hessian(jnp.asarray(u), 1.245, SPACING,
                            z_valid_radius=z_valid_radius, mode=mode)
    assert got.shape == (6, *np.asarray(want[0]).shape)
    _close(got, np.stack(want))


def test_hessian_refusals_apply_to_cuda_only():
    """With use_kernels on a CPU tensor every kernel wrapper (B6, B10, B11)
    runs its plain version: the same result as use_kernels=False.  On the
    card the same calls launch the kernels
    (tests/test_torch_cuda_ved.py::test_gaussian_derivative_through_kernels);
    only an unknown mode is refused."""
    u = torch.as_tensor(_field((6, 7, 8), 7))
    a = hessian.hessian(u, 1.0, mode="gaussian_derivative", use_kernels=True)
    b = hessian.hessian(u, 1.0, mode="gaussian_derivative")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    a = hessian.hessian(u, 1.0, mode="smooth_fd", use_kernels=True)
    b = hessian.hessian(u, 1.0, mode="smooth_fd")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode"):
        hessian.hessian(u, 1.0, mode="sobel")
