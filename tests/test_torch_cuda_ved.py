"""The VED kernels (B6-B11) against their plain PyTorch versions on the card,
and the VED pipeline through them.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one;
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_ved.py`` runs
them on a machine with a card.  Tolerances: every kernel rounds each
operation as its plain version does (no fused multiply-adds), so they agree
to the last bits wherever the math library does; they are held to float64
1e-12 and float32 1e-5 of the largest reference value, bf16 one bf16 ulp of
each value (f32 floor near zero), except where two correct versions may
legitimately part: a select decision at a near-tie (B8's Hessian planes)
and a degenerate top eigenvalue (B9's eigenvector), both counted and
bounded.
"""

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch import VEDConfig, ved
from multigridanisotropicdiffusion_tpu_torch.models.ved import (
    _make_assemble_fn,
    fused_vesselness_tensor,
    vesselness_measure,
)
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv, cuda_vesselness
from multigridanisotropicdiffusion_tpu_torch.ops.eigen3 import eigvalsh3
from multigridanisotropicdiffusion_tpu_torch.ops.hessian import (
    fd_factors,
    gaussian_kernels_1d,
    hessian,
    smoothed_field_valid_z,
)
from multigridanisotropicdiffusion_tpu_torch.utils.compare import degenerate_tops, select_flips

pytestmark = pytest.mark.cuda

DTYPES = [torch.float64, torch.float32, torch.bfloat16]
PARAMS = (0.5, 0.5, 5.0)
TENSOR = (0.01, 5.0, 10.0)
COUNTERS = (cuda_conv.conv_z, cuda_conv.conv_yx, cuda_vesselness.fd_vesselness,
            cuda_vesselness.tensor_assembly)
#: the kernels of hessian(mode='gaussian_derivative') (B6, B10)
GD_COUNTERS = (cuda_conv.conv_z, cuda_conv.conv_y, cuda_conv.conv_x)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(got, want, rel=None):
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.double(), want.double()
    scale = w.abs().max().item()
    err = (g - w).abs()
    assert bool(torch.isfinite(g).all() == torch.isfinite(w).all())
    if want.dtype == torch.bfloat16:
        a = w.abs().clamp_min(torch.finfo(torch.float32).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
        assert bool((err <= torch.maximum(ulp, torch.full_like(ulp, 1e-5 * scale))).all())
    else:
        tol = rel or (1e-12 if want.dtype == torch.float64 else 1e-5)
        assert err.max().item() <= tol * scale, (err.max().item(), scale)


def _volume(shape, device, seed=0, dtype=torch.float32):
    """A bright tube along z plus uniform noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z, y, x = (torch.arange(n, device=device, dtype=torch.float32) for n in shape)
    r2 = (y[:, None] - shape[1] / 2) ** 2 + (x[None, :] - shape[2] / 3) ** 2
    vol = 100.0 * torch.exp(-r2 / 8.0)[None].expand(shape)
    return (vol + 10.0 * torch.rand(shape, generator=gen, device=device)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,sigma,spacing", [
    ((37, 45, 51), 2.0, 1.0),      # odd shape, r = 8
    ((20, 17, 33), 2.0, 0.25),     # r = 32
    ((9, 70, 140), 16.0, 1.0),     # r = 64, the cap
])
def test_conv_kernels_match_plain(device, shape, sigma, spacing, dtype):
    u = _volume(shape, device, dtype=dtype)
    taps = gaussian_kernels_1d(sigma, spacing)[0]
    r = (len(taps) - 1) // 2
    _check(cuda_conv.conv_z(u, taps), cuda_conv.conv_z_plain(u, taps))
    up = cuda_conv.edge_pad(u, r).contiguous()
    _check(cuda_conv.conv_z(up, taps, valid=True),
           cuda_conv.conv_z_plain(up, taps, valid=True))
    # zero-padded taps (the z-slab pipeline's short kernels)
    short = np.pad(gaussian_kernels_1d(0.3, 1.0)[0], (r - 2, r - 2))
    _check(cuda_conv.conv_z(up, short, valid=True),
           cuda_conv.conv_z_plain(up, short, valid=True))
    ty = gaussian_kernels_1d(sigma, spacing)[0]
    tx = gaussian_kernels_1d(0.775, 1.0)[0]
    for a, b in ((ty, tx), (tx, ty)):
        _check(cuda_conv.conv_yx(u, a, b), cuda_conv.conv_yx_plain(u, a, b))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,sigma,spacing", [
    ((37, 45, 51), 2.0, 1.0),      # odd shape, r = 8
    ((20, 17, 33), 2.0, 0.25),     # r = 32
    ((9, 70, 140), 16.0, 1.0),     # r = 64, the cap, wider than y
])
def test_conv_axis_kernels_match_plain(device, shape, sigma, spacing, dtype):
    """B10: the single-axis y and x passes, each rounded at its store, for
    every derivative order (g, g1, g2)."""
    u = _volume(shape, device, dtype=dtype)
    for taps in gaussian_kernels_1d(sigma, spacing):
        _check(cuda_conv.conv_y(u, taps), cuda_conv.conv_y_plain(u, taps))
        _check(cuda_conv.conv_x(u, taps), cuda_conv.conv_x_plain(u, taps))
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(39, 45, 51), (12, 16, 128), (3, 1, 1)])
def test_fd_hessian_matches_plain(device, shape, dtype):
    """B11: the six FD planes of a valid-z smoothed field, rounded to the
    storage dtype, y and x edge-replicated."""
    us = _volume(shape, device, dtype=dtype)
    facs = fd_factors(1.245, (1.0, 0.9, 1.1))
    got = cuda_vesselness.fd_hessian(us, facs)
    assert got.shape == (6, shape[0] - 2, *shape[1:]) and got.dtype == dtype
    _check(got, cuda_vesselness.fd_hessian_plain(us, facs))
    torch.cuda.synchronize()


def _smoothed(shape, sigma, device, dtype, seed=0):
    u = _volume(shape, device, seed, dtype)
    return smoothed_field_valid_z(u, sigma, (1.0, 1.0, 1.0), use_kernels=True)


def _check_select(got, want, new_k, new_p, best_resp, rel):
    """B8's select variant: the response everywhere; the Hessian wherever the
    two versions took the same decision (``utils.compare.select_flips``)."""
    _check(got[0], want[0], rel)
    sel = select_flips(new_k, new_p, best_resp, want[0].abs().max().item())
    assert sel.ok, sel[1:]
    _check(got[1][:, sel.keep], want[1][:, sel.keep], rel)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(12, 16, 128), (37, 45, 51)])
def test_fd_vesselness_and_assembly_match_plain(device, shape, dtype):
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    spacing = (1.0, 0.9, 1.1)
    us1 = _smoothed(shape, 1.245, device, dtype)
    us2 = _smoothed(shape, 2.0, device, dtype, seed=1)
    f1, f2 = fd_factors(1.245, spacing), fd_factors(2.0, spacing)
    first = cuda_vesselness.fd_vesselness(us1, f1, PARAMS)
    first_p = cuda_vesselness.fd_vesselness_plain(us1, f1, PARAMS, None,
                                                  vesselness_measure)
    _check(first[0], first_p[0], rel)
    _check(first[1], first_p[1], rel)
    new_k = cuda_vesselness.fd_vesselness(us2, f2, PARAMS)[0]
    new_p = cuda_vesselness.fd_vesselness_plain(us2, f2, PARAMS, None,
                                                vesselness_measure)[0]
    incoming = (first[0].clone(), first[1].clone())
    got = cuda_vesselness.fd_vesselness(us2, f2, PARAMS, first)
    assert got[0].data_ptr() == first[0].data_ptr()  # updated in place
    want = cuda_vesselness.fd_vesselness_plain(us2, f2, PARAMS, incoming,
                                               vesselness_measure)
    _check_select(got, want, new_k, new_p, incoming[0], rel)

    resp, h = want
    t = cuda_vesselness.tensor_assembly(resp, h, *TENSOR)
    t_p = cuda_vesselness.tensor_assembly_plain(resp, h, _make_assemble_fn(*TENSOR))
    _check_tensor(t, t_p, resp, h, rel)
    torch.cuda.synchronize()


def _check_tensor(got, want, resp, h, rel):
    """B9: everywhere but at a degenerate top eigenvalue, where only the
    trace is fixed (``utils.compare.degenerate_tops``)."""
    deg = degenerate_tops(got, want, resp, h, rel)
    assert deg.ok, deg[1:]
    _check(got[:, deg.keep], want[:, deg.keep], rel)


def _nan_hessian_input(device):
    """A smoothed field whose FD Hessian at voxel (1, 3, 5) is -I plus a
    1e-18 off-diagonal entry: float32 then gives p ~ 6e-19, inv_p^3 = inf and
    r = 0 * inf = NaN in the eigenvalue formula (ADVICE r5 #1)."""
    us = torch.zeros((6, 8, 32), device=device)
    k, j, i = 2, 3, 5  # output voxel (1, 3, 5): z carries a 1-plane halo
    for dz, dy, dx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
                       (0, 0, -1)):
        us[k + dz, j + dy, i + dx] = -0.5
    us[k + 1, j + 1, i] = 4e-18  # only h01 reads this corner
    return us


def test_nan_eigenvalues_match_plain(device):
    """The kernels must propagate NaN through clamps and maxima as
    torch.clamp and torch.maximum do (CUDA's fminf / fmaxf would not)."""
    us = _nan_hessian_input(device)
    facs = fd_factors(1.0, (1.0, 1.0, 1.0))
    want = cuda_vesselness.fd_vesselness_plain(us, facs, PARAMS, None,
                                               vesselness_measure)
    assert bool(torch.isnan(eigvalsh3(want[1])[:, 1, 3, 5]).all())
    got = cuda_vesselness.fd_vesselness(us, facs, PARAMS)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    resp = torch.full(want[0].shape, 0.5, device=device)
    t = cuda_vesselness.tensor_assembly(resp, want[1], *TENSOR)
    t_p = cuda_vesselness.tensor_assembly_plain(resp, want[1],
                                                _make_assemble_fn(*TENSOR))
    assert bool(torch.isfinite(t_p).all())
    torch.testing.assert_close(t, t_p, rtol=0, atol=1e-6)


def test_gaussian_derivative_through_kernels(device):
    """The reference-faithful Hessian launches B6 (3 shared z passes) and
    B10 (6 y and 6 x passes) per scale, the standalone smooth_fd Hessian
    B11 once; both match their plain paths, and so does the whole VED."""
    u = _volume((24, 20, 18), device)
    for f in GD_COUNTERS + (cuda_vesselness.fd_hessian,):
        f.launches = 0
    got = hessian(u, 1.0, (1.0, 0.9, 1.1), mode="gaussian_derivative", use_kernels=True)
    assert [f.launches for f in GD_COUNTERS] == [3, 6, 6]
    _check(got, hessian(u, 1.0, (1.0, 0.9, 1.1), mode="gaussian_derivative"))
    got = hessian(u, 1.0, mode="smooth_fd", use_kernels=True)
    assert cuda_vesselness.fd_hessian.launches == 1
    _check(got, hessian(u, 1.0, mode="smooth_fd"))

    vol = _volume((32, 36, 33), device)
    kw = dict(scales=(0.775, 2.0), diffusion_iterations=2, pipeline_z_slab=8,
              hessian_mode="gaussian_derivative")
    for f in GD_COUNTERS:
        f.launches = 0
    res = ved(vol, config=VEDConfig.cuda(**kw), device=device)
    # 4 slabs x 2 scales x (3 z, 6 y, 6 x)
    assert [f.launches for f in GD_COUNTERS] == [24, 48, 48]
    ref = ved(vol, config=VEDConfig.cuda(use_kernels=False, **kw), device=device)
    for r in (res, ref):
        assert bool((r.diffusion.final_residual <= 1e-6).all())
    rel = ((res.output - ref.output).norm() / ref.output.norm()).item()
    assert rel <= 1e-4


def test_ved_through_kernels_matches_plain(device):
    vol = _volume((40, 36, 33), device)
    kw = dict(scales=(0.775, 1.245, 2.0), diffusion_iterations=2,
              pipeline_z_slab=8)
    for f in COUNTERS:
        f.launches = 0
    res = ved(vol, config=VEDConfig.cuda(**kw), device=device)
    assert all(f.launches > 0 for f in COUNTERS)
    ref = ved(vol, config=VEDConfig.cuda(use_kernels=False, **kw), device=device)
    for r in (res, ref):
        assert bool((r.diffusion.final_residual <= 1e-6).all())
    rel = ((res.output - ref.output).norm() / ref.output.norm()).item()
    assert rel <= 1e-4


def test_bf16_pipeline_through_kernels_close_to_f32(device):
    """bf16 storage on the kernel path: the math stays float32, and the
    response and tensor stay as close to float32's as the JAX package holds
    its bf16 pipeline (tests/test_ved.py::test_ved_bf16_pipeline_close_to_f32,
    whose phantom this is)."""
    n = 32
    rng = np.random.default_rng(0)
    z = np.arange(n, dtype=np.float64)
    yy, xx = np.meshgrid(z, z, indexing="ij")
    vol = np.zeros((n, n, n))
    vol += 80.0 * np.exp(-(((yy - 10) ** 2) + (xx - 20) ** 2) / 8.0)[None]
    vol += 90.0 * np.exp(-(((z[:, None] - 10) ** 2)[:, :, None]
                           + ((xx - 24) ** 2)[None]) / 8.0)
    vol += 2.0 * rng.normal(size=(n, n, n))
    u = torch.as_tensor(vol, dtype=torch.float32, device=device)
    args = ((0.5, 1.0, 2.0), (1.0, 1.0, 1.0), 0.5, 0.5, 5.0, 0.01, 5.0, 10.0,
            None, "smooth_fd")
    r32, t32 = fused_vesselness_tensor(u, *args, use_kernels=True)
    r16, t16 = fused_vesselness_tensor(u, *args, "bfloat16", use_kernels=True)
    assert r16.dtype == t16.dtype == torch.float32
    assert (r32 - r16).abs().mean().item() < 1e-2
    assert ((t32 - t16).abs().mean((1, 2, 3)) < 0.05).all()
