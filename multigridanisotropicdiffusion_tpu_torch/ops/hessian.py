"""Separable Gaussian-derivative Hessian of a scalar field.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.hessian``: FIR
separable correlations with moment-corrected sampled Gaussian kernels,
truncated at 4 sigma (the reference wraps ITK's recursive Gaussian), and
the scale normalization ``sigma**2``.  Derivatives are in physical
coordinates.  A Hessian is one ``(6, *shape)`` stack in symfield order.

``use_kernels`` stands for the JAX package's ``allow_pallas`` together with
its ``default_backend() == "tpu"`` gates: on a 3D field every 1-D pass goes
to a kernel of :mod:`.cuda_conv` (z to B6, y and x to B10; the ``smooth_fd``
smoothing fuses y and x into B7), and the ``smooth_fd`` finite differences
to B11 (:mod:`.cuda_vesselness`).  The wrappers run their plain versions on
a CPU tensor.  ``gaussian_derivative`` mode shares the z passes explicitly
(3 per scale, then 6 y and 6 x passes), as XLA's common-subexpression
elimination does for the JAX package under ``jit``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.stencil import compute_dtype
from ..core.symfield import sym_pairs
from . import cuda_conv


@lru_cache(maxsize=256)
def gaussian_kernels_1d(
    sigma: float, spacing: float, max_radius: int = 64
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sampled Gaussian (g), first (g1) and second (g2) physical-derivative
    kernels for one axis; ``k[j]`` is the coefficient of ``u[x + j - r]``.
    Moment-corrected: exact on constants, linears and quadratics."""
    radius = kernel_radius(sigma, spacing, max_radius)
    j = np.arange(-radius, radius + 1, dtype=np.float64)
    x = j * spacing

    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()

    g1 = x / sigma**2 * g
    g1 -= g1.mean()
    m1 = np.sum(g1 * x)
    g1 /= m1

    g2 = (x**2 / sigma**4 - 1.0 / sigma**2) * g
    g2 -= g2.mean()
    m2 = np.sum(g2 * x * x) / 2.0
    g2 /= m2

    return g, g1, g2


def kernel_radius(sigma: float, spacing: float, max_radius: int = 64) -> int:
    """Radius of the sampled kernels for (sigma, spacing): the halo a tiled
    caller must provide."""
    return max(2, min(max_radius, int(math.ceil(4.0 * sigma / spacing))))


def _conv_axis(u: torch.Tensor, kernel, axis: int, valid: bool = False,
               use_kernels: bool = False) -> torch.Tensor:
    """Correlate ``u`` with a 1-D kernel along ``axis``: edge-replicated and
    shape-preserving, or (``valid``) over supplied halos, 2r shorter.  With
    ``use_kernels`` on a 3D field, the pass goes to its kernel (valid mode
    along z only, as the JAX package routes it)."""
    if use_kernels and u.dim() == 3 and (axis == 0 or not valid):
        if axis == 0:
            return cuda_conv.conv_z(u, kernel, valid=valid)
        return (cuda_conv.conv_y if axis == 1 else cuda_conv.conv_x)(u, kernel)
    return cuda_conv.conv_axis_plain(u, kernel, axis, valid)


def hessian(
    u: torch.Tensor,
    sigma: float,
    spacing: Sequence[float] | None = None,
    normalize_across_scale: bool = True,
    z_valid_radius: int | None = None,
    mode: str = "gaussian_derivative",
    use_kernels: bool = False,
) -> torch.Tensor:
    """Gaussian-smoothed Hessian ``(6, *shape)`` (3D; ``(3, *shape)`` in 2D):
    ``H[i, j] = sigma^2 d^2/dx_i dx_j (G_sigma * u)``.

    ``z_valid_radius``: the axis-0 passes run in valid mode over a halo of
    that thickness (kernels zero-padded to it; +1 in ``smooth_fd`` mode),
    and the output is ``2 * z_valid_radius`` thinner.  ``mode`` is
    ``'gaussian_derivative'`` (exact sampled derivative kernels per
    component) or ``'smooth_fd'`` (smooth once, then central differences).
    """
    ndim = u.dim()
    if spacing is None:
        spacing = (1.0,) * ndim
    if mode == "smooth_fd":
        return _hessian_smooth_fd(u, sigma, spacing, normalize_across_scale,
                                  z_valid_radius, use_kernels)
    if mode != "gaussian_derivative":
        raise ValueError(f"unknown hessian mode: {mode!r}")
    kernels = [gaussian_kernels_1d(float(sigma), float(h)) for h in spacing]
    if z_valid_radius is not None:
        r = (len(kernels[0][0]) - 1) // 2
        if z_valid_radius < r:
            raise ValueError(
                f"z_valid_radius {z_valid_radius} < kernel radius {r} "
                f"for sigma={sigma}, spacing={spacing[0]}"
            )
        extra = z_valid_radius - r
        kernels[0] = tuple(np.pad(k, (extra, extra)) for k in kernels[0])

    # the axis-0 pass of each derivative order is shared by the components
    # that start with it: 3 of them instead of 6 in 3D
    first_pass = {}

    def separable(orders):
        o = orders[0]
        if o not in first_pass:
            first_pass[o] = _conv_axis(u, kernels[0][o], 0,
                                       valid=z_valid_radius is not None,
                                       use_kernels=use_kernels)
        out = first_pass[o]
        for d in range(1, ndim):
            out = _conv_axis(out, kernels[d][orders[d]], d, use_kernels=use_kernels)
        return out

    norm = float(sigma) ** 2 if normalize_across_scale else 1.0
    planes = []
    for i, j in sym_pairs(ndim):
        orders = [0] * ndim
        if i == j:
            orders[i] = 2
        else:
            orders[i] = 1
            orders[j] = 1
        planes.append(separable(orders) * norm)
    return torch.stack(planes)


def smoothed_field_valid_z(
    u: torch.Tensor,
    sigma: float,
    spacing: Sequence[float],
    z_valid_radius: int | None = None,
    use_kernels: bool = False,
) -> torch.Tensor:
    """Gaussian-smooth ``u`` (one pass per axis), keeping a 1-plane z halo for
    a valid-z finite-difference pass.  With ``z_valid_radius`` the input
    carries that halo (the z-slab pipeline); without it the input is
    edge-padded first, so tiled and untiled pipelines agree at the z
    borders.  With ``use_kernels`` on a 3D field, z goes to B6 (valid mode)
    and y+x to the fused B7."""
    ndim = u.dim()
    if z_valid_radius is None:
        r = kernel_radius(float(sigma), float(spacing[0]))
        z_valid_radius = r + 1
        u = cuda_conv.edge_pad(u, z_valid_radius)
    g = gaussian_kernels_1d(float(sigma), float(spacing[0]))[0]
    r = (len(g) - 1) // 2
    if z_valid_radius < r + 1:
        raise ValueError(
            f"z_valid_radius {z_valid_radius} < kernel radius + 1 = {r + 1} "
            f"for sigma={sigma}, spacing={spacing[0]} (smooth_fd mode needs "
            "one extra halo plane)"
        )
    extra = (z_valid_radius - 1) - r
    us = _conv_axis(u, np.pad(g, (extra, extra)), 0, valid=True,
                    use_kernels=use_kernels)
    if use_kernels and ndim == 3:
        gy = gaussian_kernels_1d(float(sigma), float(spacing[1]))[0]
        gx = gaussian_kernels_1d(float(sigma), float(spacing[2]))[0]
        return cuda_conv.conv_yx(us, gy, gx)
    for d in range(1, ndim):
        g = gaussian_kernels_1d(float(sigma), float(spacing[d]))[0]
        us = _conv_axis(us, g, d)
    return us


def fd_factors(
    sigma: float, spacing: Sequence[float],
    normalize_across_scale: bool = True,
) -> Tuple[float, ...]:
    """Per-plane factors of the 3D central-difference Hessian (symfield
    order): (f00, f01, f02, f11, f12, f22)."""
    norm = float(sigma) ** 2 if normalize_across_scale else 1.0
    h0, h1, h2 = (float(h) for h in spacing)
    return (
        norm / h0 ** 2, norm / (4 * h0 * h1), norm / (4 * h0 * h2),
        norm / h1 ** 2, norm / (4 * h1 * h2), norm / h2 ** 2,
    )


def fd_planes(us: torch.Tensor, facs: Sequence[float]) -> torch.Tensor:
    """Central-difference Hessian ``(S, *out)`` of a valid-z smoothed field
    (1-plane z halo; the other axes replicate their edges), in the compute
    dtype, unrounded.  ``facs``: one factor per symfield component."""
    ndim = us.dim()
    cd = compute_dtype(us.dtype)
    out_shape = (us.shape[0] - 2, *us.shape[1:])
    up = us
    for d in range(1, ndim):
        up = cuda_conv.edge_pad(up, 1, d)

    def sh(off):
        sl = tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, out_shape))
        return up[sl].to(cd)

    def unit(d, s=1):
        e = [0] * ndim
        e[d] = s
        return tuple(e)

    def add(a, b):
        return tuple(x + y for x, y in zip(a, b))

    center = sh((0,) * ndim)
    planes = []
    for f, (i, j) in zip(facs, sym_pairs(ndim)):
        if i == j:
            planes.append((sh(unit(i)) - 2.0 * center + sh(unit(i, -1))) * f)
        else:
            planes.append(
                (sh(add(unit(i), unit(j))) - sh(add(unit(i), unit(j, -1)))
                 - sh(add(unit(i, -1), unit(j))) + sh(add(unit(i, -1), unit(j, -1))))
                * f
            )
    return torch.stack(planes)


def _hessian_smooth_fd(
    u: torch.Tensor,
    sigma: float,
    spacing: Sequence[float],
    normalize_across_scale: bool,
    z_valid_radius: int | None,
    use_kernels: bool = False,
) -> torch.Tensor:
    """Smooth-then-finite-difference Hessian (see :func:`hessian`), in the
    field's storage dtype."""
    us = smoothed_field_valid_z(u, sigma, spacing, z_valid_radius, use_kernels)
    ndim = u.dim()
    norm = float(sigma) ** 2 if normalize_across_scale else 1.0
    facs = [norm / (float(spacing[i]) ** 2) if i == j
            else norm / (4.0 * float(spacing[i]) * float(spacing[j]))
            for i, j in sym_pairs(ndim)]
    if use_kernels and ndim == 3:
        from .cuda_vesselness import fd_hessian  # imports this module

        return fd_hessian(us, facs)
    return fd_planes(us, facs).to(us.dtype)
