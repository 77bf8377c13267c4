"""The host plans of the single-axis convolution kernels (B6 ``conv_z``, B10
``conv_y``/``conv_x``), held bit for bit to ``conv_axis_plain`` on the CPU.

Each plan (``ops.cuda_conv.axis_plan``) is applied the way the kernels
apply it: output k sums ``w_i u[clamp(k + base + off_i + r)]`` over the
plan's list in order, each sum starting at its first product, in the
compute dtype, rounded once.  That is compared with the plain version on
the original taps by the bytes of the result (signed zeros included), in
float32, bfloat16 and float64: for the five VED scales' taps as the
``smooth_fd`` and ``gaussian_derivative`` slab pipelines pass them (zero
padded to the largest radius), in edge and valid mode, for a kernel with an
interior zero, for r = 32 and r = 64.  A field of -0.0 keeps -0.0 through
each pass's plain version, the reference for the kernels' signed zeros."""

import numpy as np
import pytest
import torch

from multigridanisotropicdiffusion_tpu_torch.core.stencil import compute_dtype
from multigridanisotropicdiffusion_tpu_torch.models.ved import VEDConfig, fused_vesselness_tensor
from multigridanisotropicdiffusion_tpu_torch.ops import cuda_conv
from multigridanisotropicdiffusion_tpu_torch.ops.hessian import gaussian_kernels_1d, kernel_radius

DTYPES = [torch.float32, torch.bfloat16, torch.float64]
SCALES = VEDConfig().scales
INTS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    return t.contiguous().view(INTS[t.element_size()])


def _field(shape, dtype, seed=0):
    u = np.random.default_rng(seed).normal(size=shape) * 10.0
    return torch.as_tensor(u).to(dtype)


def _apply_plan(u, plan, axis, valid):
    """The kernels' sums as ``plan`` lays them out along ``axis``."""
    n_in = u.shape[axis]
    n_out = n_in - 2 * (plan.r + plan.shift) if valid else n_in
    wdt = np.float64 if u.dtype == torch.float64 else np.float32
    base = plan.base(valid)
    acc = None
    for d, w in zip(plan.offsets, plan.weights.astype(wdt)):
        idx = (torch.arange(n_out) + base + int(d) + plan.r).clamp_(0, n_in - 1)
        term = float(w) * u.index_select(axis, idx).to(compute_dtype(u.dtype))
        acc = term if acc is None else acc + term
    return acc.to(u.dtype)


def _check_plan(u, taps, axis, valid):
    plan = cuda_conv.axis_plan(taps)
    k = np.asarray(taps, np.float64)
    r_full = (len(k) - 1) // 2
    assert plan.offsets.dtype == np.int32 and np.all(np.diff(plan.offsets) > 0)
    assert np.all(plan.weights != 0) and plan.r + plan.shift == r_full
    dense = np.zeros(len(k))
    dense[plan.offsets + r_full] = plan.weights
    np.testing.assert_array_equal(dense, k)
    assert not k[:plan.shift].any() and not k[len(k) - plan.shift:].any()
    assert k[plan.shift] != 0 or k[len(k) - 1 - plan.shift] != 0
    if plan.radius:
        assert plan.radius == plan.r and len(plan.weights) == 2 * plan.r + 1
    got = _apply_plan(u, plan, axis, valid)
    want = cuda_conv.conv_axis_plain(u, taps, axis, valid)
    assert torch.equal(_bits(got), _bits(want))
    return plan


def _pipeline_taps(mode):
    """The taps each single-axis pass receives in one slab-tiled
    ``fused_vesselness_tensor`` call of ``mode``, by kernel and mode:
    ``{(name, valid): [taps, ...]}``, each distinct list once."""
    seen = {}

    def recorder(name, plain):
        def record(u, taps, valid=False):
            key = (name, valid)
            if not any(np.array_equal(taps, t) for t in seen.setdefault(key, [])):
                seen[key].append(np.asarray(taps))
            return plain(u, taps, valid) if name == "conv_z" else plain(u, taps)
        return record

    cfg = VEDConfig()
    u = _field((16, 10, 9), torch.float64, 3)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("conv_z", "conv_y", "conv_x"):
            mp.setattr(cuda_conv, name, recorder(name, getattr(cuda_conv, f"{name}_plain")))
        fused_vesselness_tensor(u, SCALES, (1.0,) * 3, cfg.alpha, cfg.beta, cfg.gamma,
                                cfg.epsilon, cfg.omega, cfg.sensitivity, z_slab=8,
                                hessian_mode=mode, use_kernels=True)
    return seen


@pytest.mark.parametrize("mode", ["smooth_fd", "gaussian_derivative"])
def test_pipeline_taps_plan_to_compiled_radii(mode):
    """Every scale's taps, as the slab pipeline pads them, strip to the
    scale's own dense taps, which have a compiled radius (g1's centre tap is
    tiny, not zero)."""
    seen = _pipeline_taps(mode)
    radius = max(kernel_radius(s, 1.0) for s in SCALES)
    want_r = sorted(kernel_radius(s, 1.0) for s in SCALES)
    z = seen[("conv_z", True)]
    assert len(z) == (5 if mode == "smooth_fd" else 15)
    for taps in z:
        assert len(taps) == 2 * radius + 1
    assert sorted({cuda_conv.axis_plan(t).radius for t in z}) == sorted(set(want_r))
    if mode == "gaussian_derivative":
        for name in ("conv_y", "conv_x"):
            plans = [cuda_conv.axis_plan(t) for t in seen[(name, False)]]
            assert len(plans) == 15 and all(p.shift == 0 for p in plans)
            assert sorted({p.radius for p in plans}) == sorted(set(want_r))
    else:
        assert ("conv_y", False) not in seen and ("conv_x", False) not in seen


def _cases():
    """(name, taps, axis, valid) of the plans to check."""
    cases = []
    for sigma in SCALES:
        r = kernel_radius(sigma, 1.0)
        for o, k in enumerate(gaussian_kernels_1d(sigma, 1.0)):
            for pad_to in (8, 9):  # the gaussian_derivative and smooth_fd halos
                padded = np.pad(k, pad_to - r)
                cases.append((f"s{sigma} g{o} pad{pad_to} z valid", padded, 0, True))
                cases.append((f"s{sigma} g{o} pad{pad_to} z edge", padded, 0, False))
            cases.append((f"s{sigma} g{o} y", k, 1, False))
            cases.append((f"s{sigma} g{o} x", k, 2, False))
    hole = gaussian_kernels_1d(1.245, 1.0)[2].copy()
    hole[3] = 0.0
    cases.append(("interior zero z valid", np.pad(hole, 2), 0, True))
    cases.append(("interior zero y", hole, 1, False))
    for sigma, h, name in ((2.0, 0.25, "r=32"), (16.0, 1.0, "r=64")):
        k = gaussian_kernels_1d(sigma, h)[2]
        cases.append((f"{name} z valid", k, 0, True))
        cases.append((f"{name} x", k, 2, False))
    return cases


CASES = _cases()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_axis_plans_are_conv_axis_plain_bit_for_bit(dtype):
    fields = {}
    compiled = set()
    for name, taps, axis, valid in CASES:
        r = (len(taps) - 1) // 2
        shape = [6, 7, 9]
        shape[axis] += 2 * r if valid else min(r, 12)
        key = (tuple(shape), valid)
        if key not in fields:
            fields[key] = _field(tuple(shape), dtype, len(fields))
        plan = _check_plan(fields[key], taps, axis, valid)
        compiled.add(plan.radius)
        if name.startswith(("interior", "r=")):
            assert plan.radius == 0, name
    assert compiled == {0, *cuda_conv.COMPILED_RADII}


def test_axis_plan_refuses_what_no_form_takes():
    with pytest.raises(ValueError, match="all zero"):
        cuda_conv.axis_plan(np.zeros(17))
    with pytest.raises(ValueError):
        cuda_conv.axis_plan(np.ones(4))
    with pytest.raises(ValueError):
        cuda_conv.axis_plan(np.ones(131))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_passes_keep_negative_zero(dtype):
    """Gaussian taps on a field of -0.0: every product is -0, and a sum that
    starts at its first product stays -0 (one that starts at +0 would not)."""
    g = gaussian_kernels_1d(1.245, 1.0)[0]
    r = (len(g) - 1) // 2
    u = torch.full((10 + 2 * r, 6, 7), -0.0, dtype=dtype)
    negzero = _bits(torch.full((1,), -0.0, dtype=dtype))[0]
    outs = [cuda_conv.conv_z_plain(u, g), cuda_conv.conv_z_plain(u, g, valid=True),
            cuda_conv.conv_z_plain(u, np.pad(g, 3), valid=True),
            cuda_conv.conv_y_plain(u, g), cuda_conv.conv_x_plain(u, g)]
    for out in outs:
        assert bool((_bits(out) == negzero).all())
    plan = cuda_conv.axis_plan(g)
    assert bool((_bits(_apply_plan(u, plan, 1, False)) == negzero).all())
