"""Closed-form eigendecomposition of symmetric 3x3 matrix fields.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.eigen3``: the analytic
(trigonometric) eigenvalues and cross-product eigenvectors as elementwise
tensor ops.  A symmetric field is one ``(6, *shape)`` stack in symfield order
``(a00, a01, a02, a11, a12, a22)``; eigenvalues come back as a ``(3, *shape)``
stack in ascending value order (as ``vnl_symmetric_eigensystem`` orders them)
and eigenvectors as ``v[i, j]`` = component ``i`` of the eigenvector of
``w[j]``, a ``(3, 3, *shape)`` stack.

The JAX package's ``acos_poly`` exists only because Mosaic has no arccos;
here ``torch.acos`` is used (the polynomial differs by ~2e-8).

Every operation is a separate PyTorch op, rounded once, in the order the CUDA
kernels of ``csrc/vesselness.cu`` evaluate it (they switch off contraction
into fused multiply-adds), so the kernels and these plain versions agree to
the last bit where the math library's functions do.  ``torch.maximum`` and
``torch.clamp`` propagate NaN, which the kernels reproduce (ADVICE r5 #1:
a tiny nonzero ``p`` makes ``r = 0 * inf``).
"""

from __future__ import annotations

from typing import Tuple

import torch

Vec = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _cross(u: Vec, v: Vec) -> Vec:
    return (
        u[1] * v[2] - u[2] * v[1],
        u[2] * v[0] - u[0] * v[2],
        u[0] * v[1] - u[1] * v[0],
    )


def _dot(u: Vec, v: Vec) -> torch.Tensor:
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _pick(cond: torch.Tensor, u: Vec, v: Vec) -> Vec:
    return tuple(torch.where(cond, a, b) for a, b in zip(u, v))


def _scaled_eigenvalues(planes: torch.Tensor):
    """Entries of ``A / max|A|`` and its eigenvalues ``(lo, mid, hi)``, plus
    the scale.  The shared first half of :func:`eigh3`."""
    a00, a01, a02, a11, a12, a22 = planes.unbind(0)
    scale = torch.maximum(
        torch.maximum(torch.maximum(a00.abs(), a11.abs()), a22.abs()),
        torch.maximum(torch.maximum(a01.abs(), a02.abs()), a12.abs()),
    )
    scale_safe = torch.where(scale > 0, scale, 1.0)
    inv_scale = 1.0 / scale_safe
    a00, a11, a22, a01, a02, a12 = (
        x * inv_scale for x in (a00, a11, a22, a01, a02, a12)
    )

    q = (a00 + a11 + a22) * (1.0 / 3.0)
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 * (1.0 / 6.0), min=0.0))
    p_safe = torch.where(p > 0, p, 1.0)

    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    inv_p = 1.0 / p_safe
    inv_p3 = inv_p * inv_p * inv_p
    r = torch.clamp(detb * inv_p3 * 0.5, -1.0, 1.0)
    phi = torch.acos(r) * (1.0 / 3.0)

    # cos(phi + 2pi/3) = -cos(phi)/2 - (sqrt(3)/2) sin(phi), phi in [0, pi/3]
    c = torch.cos(phi)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    w_hi = q + 2.0 * p * c
    w_lo = q + 2.0 * p * (-0.5 * c - 0.8660254037844386 * s)
    w_mid = 3.0 * q - w_hi - w_lo
    return (a00, a01, a02, a11, a12, a22), (w_lo, w_mid, w_hi), scale_safe


def _candidate(a, lam):
    """Eigenvector candidate for scaled eigenvalue ``lam``: the largest cross
    product of two rows of ``A - lam I``, and whether it stands above the
    float noise floor (it does not for a degenerate eigenvalue)."""
    a00, a01, a02, a11, a12, a22 = a
    r0 = (a00 - lam, a01, a02)
    r1 = (a01, a11 - lam, a12)
    r2 = (a02, a12, a22 - lam)
    c0, c1, c2 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n0, n1, n2 = _dot(c0, c0), _dot(c1, c1), _dot(c2, c2)
    best = _pick(n0 >= n1, c0, c1)
    nbest = torch.maximum(n0, n1)
    best = _pick(nbest >= n2, best, c2)
    nbest = torch.maximum(nbest, n2)
    rn = torch.maximum(torch.maximum(_dot(r0, r0), _dot(r1, r1)), _dot(r2, r2))
    feps = torch.finfo(a00.dtype).eps
    ok = nbest > (64.0 * feps) ** 2 * rn * rn
    inv = torch.rsqrt(torch.where(ok, nbest, 1.0))
    return tuple(c * inv for c in best), ok


def _stable_perp(p_vec: Vec) -> Vec:
    """A unit vector orthogonal to unit ``p_vec``: its cross product with the
    canonical axis least aligned with it."""
    ax, ay, az = (c.abs() for c in p_vec)
    use_x = (ax <= ay) & (ax <= az)
    use_y = ~use_x & (ay <= az)
    use_z = ~use_x & ~use_y
    basis = tuple(u.to(ax.dtype) for u in (use_x, use_y, use_z))
    alt = _cross(p_vec, basis)
    inv = torch.rsqrt(_dot(alt, alt))
    return tuple(c * inv for c in alt)


def eigh3(planes: torch.Tensor, compute_vectors: bool = True,
          vectors_mode: str = "full"):
    """Analytic eigendecomposition of a ``(6, *shape)`` symmetric field.

    Returns ``(w, v)``: ``w`` the ``(3, *shape)`` ascending eigenvalues and
    ``v`` the ``(3, 3, *shape)`` eigenvector frame (``None`` with
    ``compute_vectors=False``).  ``vectors_mode='largest'`` returns only the
    eigenvector of the largest eigenvalue, a ``(3, *shape)`` stack; on a
    degenerate top eigenvalue it is an arbitrary deterministic unit vector of
    the eigenspace (orthogonal to the ``w_lo`` eigenvector).
    """
    a, (w_lo, w_mid, w_hi), scale_safe = _scaled_eigenvalues(planes)
    w = torch.stack((w_lo * scale_safe, w_mid * scale_safe, w_hi * scale_safe))
    if not compute_vectors:
        return w, None

    one = torch.ones_like(w_lo)
    zero = torch.zeros_like(w_lo)
    ex = (one, zero, zero)
    v_hi_c, ok_hi = _candidate(a, w_hi)
    v_lo_c, ok_lo = _candidate(a, w_lo)
    if vectors_mode == "largest":
        primary = _pick(ok_lo, v_lo_c, ex)
        return w, torch.stack(_pick(ok_hi, v_hi_c, _stable_perp(primary)))
    if vectors_mode != "full":
        raise ValueError(f"unknown vectors_mode: {vectors_mode!r}")

    # the eigenvalue farther from the middle one has the better-conditioned
    # eigenvector: take it first, and build the other orthogonally
    lo_primary = (w_mid - w_lo) >= (w_hi - w_mid)
    primary = _pick(lo_primary, v_lo_c, v_hi_c)
    primary_ok = (lo_primary & ok_lo) | (~lo_primary & ok_hi)
    primary = _pick(primary_ok, primary, ex)

    secondary = _pick(lo_primary, v_hi_c, v_lo_c)
    secondary_ok = (lo_primary & ok_hi) | (~lo_primary & ok_lo)
    dot = _dot(secondary, primary)
    sec_orth = tuple(s - dot * p for s, p in zip(secondary, primary))
    n_orth = _dot(sec_orth, sec_orth)
    sec_valid = secondary_ok & (n_orth > 0.25)
    inv = torch.rsqrt(torch.where(sec_valid, n_orth, 1.0))
    secondary = _pick(sec_valid, tuple(c * inv for c in sec_orth),
                      _stable_perp(primary))

    v_lo = _pick(lo_primary, primary, secondary)
    v_hi = _pick(lo_primary, secondary, primary)
    v_mid = _cross(v_hi, v_lo)
    v = torch.stack([torch.stack((v_lo[i], v_mid[i], v_hi[i])) for i in range(3)])
    return w, v


def eigvalsh3(planes: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of a ``(6, *shape)`` field, ``(3, *shape)``."""
    return eigh3(planes, compute_vectors=False)[0]


def sort_by_abs3(w: torch.Tensor) -> torch.Tensor:
    """Sort a ``(3, *shape)`` eigenvalue stack by |value| ascending with the
    reference's 3-swap network (itkVEDMultigridImageFilter.hxx:266-268)."""
    l0, l1, l2 = w.unbind(0)

    def swap(a, b):
        s = a.abs() > b.abs()
        return torch.where(s, b, a), torch.where(s, a, b)

    l0, l1 = swap(l0, l1)
    l1, l2 = swap(l1, l2)
    l0, l1 = swap(l0, l1)
    return torch.stack((l0, l1, l2))
