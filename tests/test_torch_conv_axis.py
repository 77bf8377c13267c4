"""Port parity, the per-axis convolution kernels (B10) and the standalone FD
Hessian (B11): their plain versions against the JAX package's Pallas kernels
in interpret mode, at ``tests/test_pallas_conv.py``'s shapes, and the
prefix-shared ``gaussian_derivative`` Hessian against the JAX ``hessian``.

Tolerances: float64 1e-12 of the largest value (the Pallas kernels sum the
taps as banded matrix products, in another order); float32 1e-6 (the same,
at float32 rounding).  The shared z passes are the same arithmetic on the
same tensors as the unshared form, so that comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu.ops import hessian as jhessian
from multigridanisotropicdiffusion_tpu.ops.pallas_conv import (
    pallas_conv_axis,
    pallas_fd_hessian,
)
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv, cuda_vesselness, hessian

DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-6)]
SPACING = (0.5, 0.3125, 0.3125)


def _field(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _kernels():
    return list(hessian.gaussian_kernels_1d(1.3, 1.0)) + [np.array([0.25, 0.5, 0.25])]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[1].__repr__())
@pytest.mark.parametrize("axis", [1, 2])
def test_conv_axis_plain_matches_the_pallas_kernels(axis, dtype):
    np_dtype, t_dtype, tol = dtype
    u = _field((12, 16, 256), axis, np_dtype)
    plain = cuda_conv.conv_y if axis == 1 else cuda_conv.conv_x
    for k in _kernels():
        want = pallas_conv_axis(jnp.asarray(u), k, axis, interpret=True)
        got = plain(torch.as_tensor(u), k)
        assert got.dtype == t_dtype
        _close(got, want, tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[1].__repr__())
def test_conv_y_large_sigma_matches_the_pallas_kernel(dtype):
    """Radius 16, half the y extent: the edge folds reach across the tile."""
    np_dtype, _, tol = dtype
    u = _field((4, 32, 256), 3, np_dtype)
    g = hessian.gaussian_kernels_1d(4.0, 1.0)[0]
    want = pallas_conv_axis(jnp.asarray(u), g, 1, interpret=True)
    _close(cuda_conv.conv_y(torch.as_tensor(u), g), want, tol)


def _smoothed(u, sigma):
    """The valid-z smoothed field the FD pass reads (1-plane z halo)."""
    return hessian.smoothed_field_valid_z(torch.as_tensor(u), sigma, SPACING)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d[1].__repr__())
def test_fd_hessian_plain_matches_the_pallas_kernel(dtype):
    np_dtype, t_dtype, tol = dtype
    us = _smoothed(_field((20, 16, 256), 4, np_dtype), 1.0)
    facs = hessian.fd_factors(1.0, SPACING)
    want = pallas_fd_hessian(jnp.asarray(us.numpy()), facs, interpret=True)
    got = cuda_vesselness.fd_hessian(us, facs)
    assert got.shape == (6, 20, 16, 256) and got.dtype == t_dtype
    _close(got, np.stack(want), tol)


def _unshared(u, sigma, spacing, z_valid_radius):
    """The gaussian_derivative Hessian with no shared passes: 18 passes."""
    ks = [hessian.gaussian_kernels_1d(sigma, h) for h in spacing]
    if z_valid_radius is not None:
        extra = z_valid_radius - (len(ks[0][0]) - 1) // 2
        ks[0] = tuple(np.pad(k, (extra, extra)) for k in ks[0])
    planes = []
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        orders = [0, 0, 0]
        orders[i] += 1
        orders[j] += 1
        out = u
        for d, o in enumerate(orders):
            out = cuda_conv.conv_axis_plain(out, ks[d][o], d,
                                            valid=d == 0 and z_valid_radius is not None)
        planes.append(out * sigma ** 2)
    return torch.stack(planes)


@pytest.mark.parametrize("z_valid_radius", [None, 8])
def test_shared_gaussian_derivative_hessian_matches_jax(monkeypatch, z_valid_radius):
    """With use_kernels: 3 z passes, 6 y and 6 x per scale; equal to the
    unshared form and to the JAX package's ``hessian``."""
    u = _field((9, 10, 11), 6)
    if z_valid_radius is not None:
        u = np.pad(u, ((z_valid_radius,) * 2, (0, 0), (0, 0)), mode="edge")
    spacing = (0.9, 1.0, 1.2)
    calls = {"conv_z": 0, "conv_y": 0, "conv_x": 0}
    for name in calls:
        fn = getattr(cuda_conv, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cuda_conv, name, counted)
    got = hessian.hessian(torch.as_tensor(u), 1.245, spacing,
                          z_valid_radius=z_valid_radius, use_kernels=True)
    assert calls == {"conv_z": 3, "conv_y": 6, "conv_x": 6}
    torch.testing.assert_close(
        got, _unshared(torch.as_tensor(u), 1.245, spacing, z_valid_radius), rtol=0, atol=0)
    want = jhessian.hessian(jnp.asarray(u), 1.245, spacing, z_valid_radius=z_valid_radius)
    _close(got, np.stack(want), 1e-12)


@pytest.mark.parametrize("z_valid_radius", [None, 9])
def test_smooth_fd_hessian_through_b11_matches_jax(z_valid_radius):
    u = _field((9, 10, 11), 7)
    if z_valid_radius is not None:
        u = np.pad(u, ((z_valid_radius,) * 2, (0, 0), (0, 0)), mode="edge")
    spacing = (1.0, 0.9, 1.1)  # r = 8 along z: a halo of 9 planes
    got = hessian.hessian(torch.as_tensor(u), 2.0, spacing, z_valid_radius=z_valid_radius,
                          mode="smooth_fd", use_kernels=True)
    want = jhessian.hessian(jnp.asarray(u), 2.0, spacing, z_valid_radius=z_valid_radius,
                            mode="smooth_fd")
    _close(got, np.stack(want), 1e-12)


@pytest.mark.parametrize("t_dtype", [torch.float32, torch.bfloat16], ids=str)
def test_single_axis_passes_round_at_their_store(t_dtype):
    """Every single-axis pass rounds to the storage dtype (as the JAX
    ``_conv_axis`` does), unlike the fused y+x pass, which rounds once."""
    g = hessian.gaussian_kernels_1d(2.0, 1.0)[1]
    u = torch.as_tensor(_field((5, 20, 21), 8)).to(t_dtype)
    for axis, fn in ((1, cuda_conv.conv_y), (2, cuda_conv.conv_x)):
        got = fn(u, g)
        assert got.dtype == t_dtype
        want = cuda_conv.conv_axis_plain(u, g, axis, round_result=False).to(t_dtype)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        ju = jnp.asarray(u.float().numpy()).astype(jnp.dtype(str(t_dtype).split(".")[1]))
        jwant = jhessian._conv_axis(ju, g, axis, allow_pallas=False)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(jwant, np.float32))
