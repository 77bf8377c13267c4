"""Plain PyTorch reference of the VED pipeline: per scale the scale-normalised
Hessian, its eigenvalues and the Frangi vesselness; the best response over
scales with its Hessian; the diffusion tensor from that Hessian's
eigenframe.  It follows the discretisation the filter states (Manniesing et
al. 2006; upstream ``itkVEDMultigridImageFilter.hxx``):

* Gaussian kernels sampled on ``[-r, r]``, ``r = max(2, min(64, ceil(4
  sigma / h)))``: ``g`` normalised to sum 1; the derivative kernels ``g1``,
  ``g2`` moment-corrected (zero sum, exact on linears / quadratics);
* ``smooth_fd``: smooth along z, y, x, then central differences; along z the
  smoothing runs over edge-replicated input planes, so the differences
  reach one smoothed plane beyond each border; along y and x the smoothed
  field is edge-replicated for the differences;
* ``gaussian_derivative``: per component the separable product of ``g``,
  ``g1`` and ``g2`` passes over edge-replicated input;
* both scaled by ``sigma**2``;
* eigenvalues by the trigonometric closed form; the vesselness
  ``exp(-2 c^2 / (|l2| l3^2)) (1 - exp(-Ra^2 / 2 alpha^2)) exp(-Rb^2 / 2
  beta^2) (1 - exp(-S^2 / 2 gamma^2))`` with ``c = 1e-5`` and the values
  sorted by magnitude, zero unless ``l2 < 0`` and ``l3 < 0``;
* the first scale starts the running best, a later one replaces it where its
  response is strictly larger;
* ``T = d1 I + (d3 - d1) q q^T`` with ``q`` the unit eigenvector of the
  largest eigenvalue, ``V = response^(1 / sensitivity)``, ``d1 = 1 +
  (epsilon - 1) V``, ``d3 = 1 + (omega - 1) V``; the identity where ``V <=
  0``.

Everything is computed in ``dtype`` in z slabs, so that a 512^3 volume fits
beside nothing else on one card.  Tensors are ``(6, Z, Y, X)`` stacks in
(zz, zy, zx, yy, yx, xx) order.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
SMOOTH_C = 1e-5


def radius(sigma: float, h: float = 1.0) -> int:
    return max(2, min(64, int(math.ceil(4.0 * sigma / h))))


def gaussian_taps(sigma: float, h: float = 1.0) -> Tuple[np.ndarray, ...]:
    """``(g, g1, g2)``: tap ``j`` weighs the sample at offset ``j - r``."""
    r = radius(sigma, h)
    x = np.arange(-r, r + 1, dtype=np.float64) * h
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    g1 = x / sigma ** 2 * g
    g1 = g1 - g1.mean()
    g1 = g1 / np.sum(g1 * x)
    g2 = (x ** 2 / sigma ** 4 - 1.0 / sigma ** 2) * g
    g2 = g2 - g2.mean()
    g2 = g2 / (np.sum(g2 * x * x) / 2.0)
    return g, g1, g2


def _replicate(u: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    n = u.shape[axis]
    idx = torch.arange(-r, n + r, device=u.device).clamp_(0, n - 1)
    return u.index_select(axis, idx)


def correlate(u: torch.Tensor, taps: np.ndarray, axis: int, edge: bool) -> torch.Tensor:
    """``out[i] = sum_j taps[j] u[i + j - r]`` along ``axis``: over
    edge-replicated samples (``edge``), or over the halo ``u`` carries (the
    output ``2 r`` shorter)."""
    r = (len(taps) - 1) // 2
    up = _replicate(u, r, axis) if edge else u
    n = up.shape[axis] - 2 * r
    shape = list(u.shape)
    shape[axis] = n
    out = torch.zeros(shape, dtype=u.dtype, device=u.device)
    for j, t in enumerate(taps):
        out.add_(up.narrow(axis, j, n), alpha=float(t))
    return out


def hessian_smooth_fd(slab: torch.Tensor, halo: int, sigma: float) -> torch.Tensor:
    """Hessian of the ``slab.shape[0] - 2 halo`` middle planes of ``slab``
    (the input with ``halo`` planes on each side), smooth then differences."""
    r = radius(sigma)
    g = gaussian_taps(sigma)[0]
    nz = slab.shape[0] - 2 * halo
    s = correlate(slab.narrow(0, halo - 1 - r, nz + 2 + 2 * r), g, 0, edge=False)
    s = correlate(correlate(s, g, 1, edge=True), g, 2, edge=True)
    p = _replicate(_replicate(s, 1, 1), 1, 2)  # (nz + 2, Y + 2, X + 2)

    def at(dz, dy, dx):
        return p[1 + dz:1 + dz + nz, 1 + dy:p.shape[1] - 1 + dy, 1 + dx:p.shape[2] - 1 + dx]

    unit = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    norm = sigma * sigma
    planes = []
    for i, j in PAIRS:
        ei, ej = unit[i], unit[j]
        if i == j:
            m = tuple(-c for c in ei)
            planes.append((at(*ei) - 2.0 * at(0, 0, 0) + at(*m)) * norm)
        else:
            pp = tuple(a + b for a, b in zip(ei, ej))
            pm = tuple(a - b for a, b in zip(ei, ej))
            mp = tuple(-a + b for a, b in zip(ei, ej))
            mm = tuple(-a - b for a, b in zip(ei, ej))
            planes.append((at(*pp) - at(*pm) - at(*mp) + at(*mm)) * (norm / 4.0))
    return torch.stack(planes)


def hessian_gaussian_derivative(slab: torch.Tensor, halo: int, sigma: float) -> torch.Tensor:
    """Hessian of the middle planes of ``slab``, one separable product of
    sampled derivative kernels per component."""
    r = radius(sigma)
    taps = gaussian_taps(sigma)
    nz = slab.shape[0] - 2 * halo
    sub = slab.narrow(0, halo - r, nz + 2 * r)
    z_pass = {}
    planes = []
    for i, j in PAIRS:
        orders = [0, 0, 0]
        orders[i] += 1
        orders[j] += 1
        if orders[0] not in z_pass:
            z_pass[orders[0]] = correlate(sub, taps[orders[0]], 0, edge=False)
        out = correlate(z_pass[orders[0]], taps[orders[1]], 1, edge=True)
        planes.append(correlate(out, taps[orders[2]], 2, edge=True) * (sigma * sigma))
    return torch.stack(planes)


def eigenvalues(h: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues ``(3, ...)`` of a symmetric field, closed form."""
    a00, a01, a02, a11, a12, a22 = h.unbind(0)
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22
                    + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0)
    ps = torch.where(p > 0, p, torch.ones_like(p))
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    phi = torch.acos(torch.clamp(det / (2.0 * ps * ps * ps), -1.0, 1.0)) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return torch.stack((lo, 3.0 * q - hi - lo, hi))


def top_eigenvector(h: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector ``(3, ...)`` of eigenvalue ``hi``: the longest cross
    product of two rows of ``H - hi I`` (any unit vector where all vanish)."""
    a00, a01, a02, a11, a12, a22 = h.unbind(0)
    rows = ((a00 - hi, a01, a02), (a01, a11 - hi, a12), (a02, a12, a22 - hi))

    def cross(u, v):
        return torch.stack((u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                            u[0] * v[1] - u[1] * v[0]))

    best = cross(rows[0], rows[1])
    nbest = (best * best).sum(0)
    for u, v in ((rows[0], rows[2]), (rows[1], rows[2])):
        c = cross(u, v)
        n = (c * c).sum(0)
        take = n > nbest
        best = torch.where(take, c, best)
        nbest = torch.where(take, n, nbest)
    ok = nbest > 0
    fallback = torch.zeros_like(best)
    fallback[2] = 1.0
    return torch.where(ok, best / torch.sqrt(torch.where(ok, nbest, 1.0)), fallback)


def vesselness(w: torch.Tensor, alpha: float, beta: float, gamma: float) -> torch.Tensor:
    """Frangi vesselness of eigenvalues ``w`` (any order)."""
    order = torch.argsort(w.abs(), dim=0)
    l1, l2, l3 = torch.gather(w, 0, order).unbind(0)
    tube = (l2 < 0) & (l3 < 0)
    l2s = torch.where(tube, l2, -1.0)
    l3s = torch.where(tube, l3, -1.0)
    ra2 = (l2s / l3s) ** 2
    rb2 = l1 * l1 / torch.abs(l2s * l3s)
    s2 = l1 * l1 + l2 * l2 + l3 * l3
    v = (torch.exp(-2.0 * SMOOTH_C * SMOOTH_C / (torch.abs(l2s) * l3s * l3s))
         * (1.0 - torch.exp(-ra2 / (2.0 * alpha * alpha)))
         * torch.exp(-rb2 / (2.0 * beta * beta))
         * (1.0 - torch.exp(-s2 / (2.0 * gamma * gamma))))
    return torch.where(tube, v, 0.0)


def diffusion_tensor(resp: torch.Tensor, h: torch.Tensor, epsilon: float, omega: float,
                     sensitivity: float) -> torch.Tensor:
    v = torch.pow(torch.clamp(resp, min=0.0), 1.0 / sensitivity)
    q = top_eigenvector(h, eigenvalues(h)[2])
    d1 = 1.0 + (epsilon - 1.0) * v
    diff = (omega - epsilon) * v
    active = v > 0
    planes = []
    for i, j in PAIRS:
        t = diff * q[i] * q[j] + (d1 if i == j else 0.0)
        planes.append(torch.where(active, t, 1.0 if i == j else 0.0))
    return torch.stack(planes)


def vesselness_tensor(u: torch.Tensor, settings: Dict, hessian_mode: str,
                      dtype=torch.float64, slab: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(response (Z, Y, X), tensor (6, Z, Y, X))`` of volume ``u``."""
    scales: Sequence[float] = [float(s) for s in settings["scales"]]
    hessian = {"smooth_fd": hessian_smooth_fd,
               "gaussian_derivative": hessian_gaussian_derivative}[hessian_mode]
    halo = max(radius(s) for s in scales) + 1
    nz = u.shape[0]
    resp = torch.empty(u.shape, dtype=dtype, device=u.device)
    tensor = torch.empty((6, *u.shape), dtype=dtype, device=u.device)
    for z0 in range(0, nz, slab):
        z1 = min(nz, z0 + slab)
        idx = torch.arange(z0 - halo, z1 + halo, device=u.device).clamp_(0, nz - 1)
        sl = u.index_select(0, idx).to(dtype)
        best = best_h = None
        for sigma in scales:
            h = hessian(sl, halo, sigma)
            r = vesselness(eigenvalues(h), settings["alpha"], settings["beta"],
                           settings["gamma"])
            if best is None:
                best, best_h = r, h
            else:
                better = r > best
                best = torch.where(better, r, best)
                best_h = torch.where(better, h, best_h)
            del h, r
        resp[z0:z1] = best
        tensor[:, z0:z1] = diffusion_tensor(best, best_h, settings["epsilon"],
                                            settings["omega"], settings["sensitivity"])
        del sl, best, best_h
    return resp, tensor
