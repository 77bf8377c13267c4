"""The VED kernels (B6-B11, B15) against their plain PyTorch versions on the
card, and the VED pipeline through them.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one;
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_ved.py`` runs
them on a machine with a card.  Tolerances: every kernel rounds each
operation as its plain version does (no fused multiply-adds), so they agree
to the last bits wherever the math library does; they are held to float64
1e-12 and float32 1e-5 of the largest reference value, bf16 one bf16 ulp of
each value (f32 floor near zero), except where two correct versions may
legitimately part: a select decision at a near-tie (B8's Hessian planes)
and a degenerate top eigenvalue (B9's eigenvector), both counted and
bounded.  B6 and B10 are also held to their plain versions' bytes (an
integer view: signed zeros count), B7 with ``torch.equal``.
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
@pytest.mark.parametrize("shape", [(37, 45, 51), (6, 40, 128), (5, 33, 263)])
@pytest.mark.parametrize("sigma,spacing,pad", [
    (0.3, 1.0, 0), (0.775, 1.0, 0), (1.245, 1.0, 0), (2.0, 1.0, 0),  # r = 2, 4, 5, 8
    (2.0, 0.25, 0),    # r = 32
    (16.0, 1.0, 0),    # r = 64, the cap
    (0.482, 1.0, 3),   # r = 2 zero-padded to 5
])
def test_conv_yx_matches_plain_bit_for_bit(device, shape, sigma, spacing, pad, dtype):
    """B7, the fused y+x pass: the compiled radii and the generic form (r =
    32, 64, zero-padded taps, different radii on y and x) on odd shapes and
    on rows of whole 16-byte vectors, equal to the plain version."""
    u = _volume(shape, device, dtype=dtype)
    taps = np.pad(gaussian_kernels_1d(sigma, spacing)[0], (pad, pad))
    other = gaussian_kernels_1d(0.775, 1.0)[0]
    before = cuda_conv.conv_yx.launches
    for a, b in ((taps, taps), (taps, other), (other, taps)):
        got = cuda_conv.conv_yx(u, a, b)
        want = cuda_conv.conv_yx_plain(u, a, b)
        _check(got, want)
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert cuda_conv.conv_yx.launches - before == 3


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
        for got, want in ((cuda_conv.conv_y(u, taps), cuda_conv.conv_y_plain(u, taps)),
                          (cuda_conv.conv_x(u, taps), cuda_conv.conv_x_plain(u, taps))):
            _check(got, want)
            assert torch.equal(got, want)
    torch.cuda.synchronize()


_INTS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _same_bits(got, want):
    """The two tensors hold the same bytes (signed zeros included)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    ints = _INTS[got.element_size()]
    assert torch.equal(got.contiguous().view(ints), want.contiguous().view(ints))


def _axis_kernels(case):
    """The g, g1 and g2 taps of a B6/B10 case: each compiled radius (the VED
    scales at unit spacing), and the generic form (r = 9, r = 32, a kernel
    with an interior zero)."""
    sigma, spacing = {"r=2": (0.3, 1.0), "r=4": (0.775, 1.0), "r=5": (1.245, 1.0),
                      "r=8": (2.0, 1.0), "r=9": (2.0, 0.9), "r=32": (2.0, 0.25),
                      "hole": (1.245, 1.0)}[case]
    kernels = [k.copy() for k in gaussian_kernels_1d(sigma, spacing)]
    if case == "hole":
        for k in kernels:
            k[2] = 0.0
    return kernels


def _misaligned(u):
    """``u``'s values, contiguous, one element past a 16-byte boundary."""
    buf = torch.empty(u.numel() + 1, dtype=u.dtype, device=u.device)
    out = buf[1:].view(u.shape)
    out.copy_(u)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(37, 45, 51), (66, 512, 512), (9, 20, 130), "misaligned"],
                         ids=str)
@pytest.mark.parametrize("case", ["r=2", "r=4", "r=5", "r=8", "r=9", "r=32", "hole"])
def test_single_axis_kernels_match_plain_bit_for_bit(device, shape, case, dtype):
    """B6 (valid mode over the taps zero-padded to radius 8 or more, as the
    z-slab pipelines pass them: the (66, 512, 512) case is the 82 -> 66
    slab; and edge mode) and B10 (y, x) hold their plain versions' bytes,
    for each derivative order: rows of whole 16-byte vectors and rows
    without (x % 4 != 0; an input one element off a 16-byte boundary)."""
    u = (_misaligned(_volume((12, 16, 128), device, dtype=dtype)) if shape == "misaligned"
         else _volume(shape, device, dtype=dtype))
    before = [f.launches for f in GD_COUNTERS]
    kernels = _axis_kernels(case)
    for taps in kernels:
        r = (len(taps) - 1) // 2
        padded = np.pad(taps, max(r, 8) - r)
        up = cuda_conv.edge_pad(u, max(r, 8)).contiguous()
        _same_bits(cuda_conv.conv_z(up, padded, valid=True),
                   cuda_conv.conv_z_plain(up, padded, valid=True))
        _same_bits(cuda_conv.conv_z(u, taps), cuda_conv.conv_z_plain(u, taps))
        _same_bits(cuda_conv.conv_y(u, taps), cuda_conv.conv_y_plain(u, taps))
        _same_bits(cuda_conv.conv_x(u, taps), cuda_conv.conv_x_plain(u, taps))
    torch.cuda.synchronize()
    n = len(kernels)
    assert [f.launches - b for f, b in zip(GD_COUNTERS, before)] == [2 * n, n, n]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(20, 33, 64), (20, 33, 51)])
def test_single_axis_kernels_keep_negative_zero(device, shape, dtype):
    """A field of -0.0 through Gaussian taps: every product is -0, and each
    sum starts at its first product, so every output is -0, as the plain
    version's (compiled radii and the generic form)."""
    u = torch.full(shape, -0.0, dtype=dtype, device=device)
    negzero = torch.full((1,), -0.0, dtype=dtype).view(_INTS[u.element_size()]).item()
    for sigma, spacing in ((0.3, 1.0), (2.0, 1.0), (2.0, 0.25)):
        g = gaussian_kernels_1d(sigma, spacing)[0]
        padded = np.pad(g, 2)
        up = cuda_conv.edge_pad(u, (len(padded) - 1) // 2).contiguous()
        for got, want in ((cuda_conv.conv_z(u, g), cuda_conv.conv_z_plain(u, g)),
                          (cuda_conv.conv_z(up, padded, valid=True),
                           cuda_conv.conv_z_plain(up, padded, valid=True)),
                          (cuda_conv.conv_y(u, g), cuda_conv.conv_y_plain(u, g)),
                          (cuda_conv.conv_x(u, g), cuda_conv.conv_x_plain(u, g))):
            _same_bits(got, want)
            assert bool((got.view(_INTS[u.element_size()]) == negzero).all())
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


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(3, 9, 33), (3, 1, 1), (19, 13, 70), (35, 8, 32),
                                   (20, 17, 31)])
def test_fd_vesselness_uneven_runs_and_tiles(device, shape, dtype):
    """B8 where the run of output planes a block marches down (16) and its
    32 x 8 (y, x) tile do not divide the shape: one output plane, a single
    voxel per plane, Y and X not multiples of the tile, 17 and 33 output
    planes.  The first scale and a select scale against the plain version,
    the select as in ``test_fd_vesselness_and_assembly_match_plain``."""
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    spacing = (1.0, 0.9, 1.1)
    us1 = _volume(shape, device, 3, dtype)
    us2 = _volume(shape, device, 4, dtype)
    f1, f2 = fd_factors(1.245, spacing), fd_factors(2.0, spacing)
    first = cuda_vesselness.fd_vesselness(us1, f1, PARAMS)
    first_p = cuda_vesselness.fd_vesselness_plain(us1, f1, PARAMS, None,
                                                  vesselness_measure)
    assert torch.equal(first[1], first_p[1])  # every plane is stored, rounded once
    _check(first[0], first_p[0], rel)
    new_k = cuda_vesselness.fd_vesselness(us2, f2, PARAMS)[0]
    new_p = cuda_vesselness.fd_vesselness_plain(us2, f2, PARAMS, None,
                                                vesselness_measure)[0]
    incoming = (first[0].clone(), first[1].clone())
    got = cuda_vesselness.fd_vesselness(us2, f2, PARAMS, first)
    want = cuda_vesselness.fd_vesselness_plain(us2, f2, PARAMS, incoming,
                                               vesselness_measure)
    _check_select(got, want, new_k, new_p, incoming[0], rel)
    torch.cuda.synchronize()


def test_nan_eigenvalues_in_the_select(device):
    """The voxel of ``_nan_hessian_input`` whose eigenvalues are NaN, in a
    select scale on either side: NaN eigenvalues are not bright, so its
    response is 0 and the select decides as the plain version does."""
    us = _nan_hessian_input(device)
    facs = fd_factors(1.0, (1.0, 1.0, 1.0))
    h = cuda_vesselness.fd_vesselness(us, facs, PARAMS)[1]
    assert bool(torch.isnan(eigvalsh3(h)[:, 1, 3, 5]).all())
    other = _volume(tuple(us.shape), device, 5)
    for first_us, second in ((other, us), (us, other)):
        start = cuda_vesselness.fd_vesselness(first_us, facs, PARAMS)
        incoming = (start[0].clone(), start[1].clone())
        got = cuda_vesselness.fd_vesselness(second, facs, PARAMS, start)
        want = cuda_vesselness.fd_vesselness_plain(second, facs, PARAMS, incoming,
                                                   vesselness_measure)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6, equal_nan=True)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6, equal_nan=True)


def _gd_hessian(shape, sigma, device, dtype, seed):
    """The gaussian_derivative Hessian stack of ``_volume`` through B6/B10,
    in the storage dtype."""
    return hessian(_volume(shape, device, seed, dtype), sigma, (1.0, 0.9, 1.1),
                   mode="gaussian_derivative", use_kernels=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(16, 16, 128), (5, 7, 9), (9, 13, 35)])
def test_hessian_vesselness_matches_plain_bit_for_bit(device, shape, dtype):
    """B15 against its plain version (the generic pipeline's per-scale
    body), bit for bit: the first scale (a new response; the input stack
    adopted as the best Hessian) and a select scale (the running best
    updated in place), on a volume of whole blocks (32768 voxels, 1024 a
    block: kVox = 4 runs of 256 threads) and on volumes that are not: 315
    voxels (one block, its second run partial, its last two empty) and 4095
    (the last block's last run one voxel short)."""
    h1 = _gd_hessian(shape, 1.245, device, dtype, 3)
    h2 = _gd_hessian(shape, 2.0, device, dtype, 4)
    first = cuda_vesselness.hessian_vesselness(h1, PARAMS)
    assert first[1] is h1  # adopted, not copied
    want = cuda_vesselness.hessian_vesselness_plain(h1, PARAMS, None, vesselness_measure)
    assert torch.equal(first[0], want[0]) and first[0].dtype == want[0].dtype
    assert bool((want[0] > 0).any())
    incoming = (first[0].clone(), first[1].clone())
    ptrs = (first[0].data_ptr(), first[1].data_ptr())
    got = cuda_vesselness.hessian_vesselness(h2, PARAMS, first)
    assert (got[0].data_ptr(), got[1].data_ptr()) == ptrs  # updated in place
    want = cuda_vesselness.hessian_vesselness_plain(h2, PARAMS, incoming,
                                                    vesselness_measure)
    assert bool((want[0] > incoming[0]).any())  # the select takes some voxels
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


def test_hessian_vesselness_nan_eigenvalues_in_the_select(device):
    """B15 on a stack whose voxel (1, 3, 5) is -I plus a 1e-18 off-diagonal
    entry, the Hessian of ``_nan_hessian_input`` (NaN eigenvalues in
    float32): not bright, so response 0, in the first scale and in a select
    scale on either side, as the plain version decides."""
    nan_h = torch.zeros((6, 4, 8, 32), device=device)
    nan_h[[0, 3, 5], 1, 3, 5] = -1.0
    nan_h[1, 1, 3, 5] = 1e-18
    assert bool(torch.isnan(eigvalsh3(nan_h)[:, 1, 3, 5]).all())
    other = _gd_hessian((4, 8, 32), 1.0, device, torch.float32, 5)
    for a, b in ((other, nan_h), (nan_h, other)):
        start = cuda_vesselness.hessian_vesselness(a.clone(), PARAMS)
        want = cuda_vesselness.hessian_vesselness_plain(a, PARAMS, None, vesselness_measure)
        assert torch.equal(start[0], want[0])
        incoming = (start[0].clone(), start[1].clone())
        got = cuda_vesselness.hessian_vesselness(b, PARAMS, start)
        want = cuda_vesselness.hessian_vesselness_plain(b, PARAMS, incoming,
                                                        vesselness_measure)
        assert float(got[0][1, 3, 5]) == float(want[0][1, 3, 5])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gaussian_derivative_through_kernels(device):
    """The reference-faithful Hessian launches B6 (3 shared z passes) and
    B10 (6 y and 6 x passes) per scale, the standalone smooth_fd Hessian
    B11 once; both match their plain paths, and so does the whole VED, whose
    pipeline launches B15 once per slab and scale and B9 once per slab."""
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
    counters = GD_COUNTERS + (cuda_vesselness.hessian_vesselness,
                              cuda_vesselness.tensor_assembly)
    for f in counters:
        f.launches = 0
    res = ved(vol, config=VEDConfig.cuda(**kw), device=device)
    # 4 slabs x 2 scales x (3 z, 6 y, 6 x; B15), 4 slabs x B9
    assert [f.launches for f in counters] == [24, 48, 48, 8, 4]
    ref = ved(vol, config=VEDConfig.cuda(use_kernels=False, **kw), device=device)
    assert [f.launches for f in counters] == [24, 48, 48, 8, 4]
    for r in (res, ref):
        assert bool((r.diffusion.final_residual <= 1e-6).all())
    rel = ((res.output - ref.output).norm() / ref.output.norm()).item()
    assert rel <= 1e-4


def test_ved_through_kernels_matches_plain(device):
    vol = _volume((40, 36, 33), device)
    kw = dict(scales=(0.775, 1.245, 2.0), diffusion_iterations=2,
              pipeline_z_slab=8)
    for f in COUNTERS + (cuda_vesselness.hessian_vesselness,):
        f.launches = 0
    res = ved(vol, config=VEDConfig.cuda(**kw), device=device)
    assert all(f.launches > 0 for f in COUNTERS)
    assert cuda_vesselness.hessian_vesselness.launches == 0  # smooth_fd keeps B8
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
