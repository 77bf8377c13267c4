"""Plain PyTorch reference of the implicit diffusion steps: the level-0
operator ``A = I - dt L`` of ``div(M grad u)`` as the upstream DCA
discretisation states it (``itkGridsHierarchy.hxx``, GenerateDCA), and a
Krylov solve of each step ``A u_{n+1} = u_n``.

The operator is the 19-point stencil (the 3x3x3 box without its corners):

* the identity on the centre;
* per axis ``d``: ``-dt/h_d^2 M_dd`` on ``+-e_d`` and twice its negative on
  the centre;
* per ordered pair ``d != d2``: ``-dt/(4 h_d h_d2) M_dd2`` on ``e_d + e_d2``
  and ``-e_d - e_d2``, its negative on ``e_d - e_d2`` and ``-e_d + e_d2``;
* per ordered pair ``(d, d2)``: the transport term, ``-dt/(4 h_d h_d2)``
  times the difference of ``M_dd2`` along ``d2`` (``M[i+1] - M[i-1]``, at the
  borders ``-3 M[0] + 4 M[1] - M[2]`` and ``3 M[-1] - 4 M[-2] + M[-3]``) on
  ``+e_d`` and its negative on ``-e_d``;
* homogeneous Neumann borders: axis by axis, on the first plane of axis
  ``d`` every coefficient whose offset steps to ``-1`` along ``d`` is added
  to the offset stepping ``+1`` instead, and likewise on the last plane.

The steps are solved with BiCGSTAB (the operator is not symmetric: the
transport term), right-preconditioned by the diagonal, from the previous
step's solution, to a relative residual ``tol``.  The solve keeps its best
iterate, so that a run in a low precision, which stalls, still answers.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

OFFSETS = tuple(off for off in itertools.product((-1, 0, 1), repeat=3)
                if not all(off))
INDEX = {off: k for k, off in enumerate(OFFSETS)}
CENTRE = INDEX[(0, 0, 0)]


def _component(tensor: torch.Tensor, d: int, d2: int) -> torch.Tensor:
    i, j = min(d, d2), max(d, d2)
    return tensor[((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)).index((i, j))]


def _difference(m: torch.Tensor, axis: int) -> torch.Tensor:
    n = m.shape[axis]
    out = torch.empty_like(m)
    out.narrow(axis, 1, n - 2).copy_(m.narrow(axis, 2, n - 2) - m.narrow(axis, 0, n - 2))
    out.narrow(axis, 0, 1).copy_(-3.0 * m.narrow(axis, 0, 1) + 4.0 * m.narrow(axis, 1, 1)
                                 - m.narrow(axis, 2, 1))
    out.narrow(axis, n - 1, 1).copy_(3.0 * m.narrow(axis, n - 1, 1)
                                     - 4.0 * m.narrow(axis, n - 2, 1)
                                     + m.narrow(axis, n - 3, 1))
    return out


def assemble(tensor: torch.Tensor, time_step: float,
             spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> torch.Tensor:
    """The ``(19, Z, Y, X)`` coefficient planes of ``A``, in ``OFFSETS``
    order, in the tensor's dtype."""
    shape = tuple(tensor.shape[1:])
    dt = float(time_step)
    c = torch.zeros((len(OFFSETS), *shape), dtype=tensor.dtype, device=tensor.device)
    c[CENTRE] = 1.0

    def e(d, s):
        off = [0, 0, 0]
        off[d] = s
        return off

    def at(*parts):
        return c[INDEX[tuple(sum(p[k] for p in parts) for k in range(3))]]

    for d in range(3):
        v = _component(tensor, d, d) * (-dt / spacing[d] ** 2)
        at(e(d, 1)).add_(v)
        at(e(d, -1)).add_(v)
        c[CENTRE].sub_(2.0 * v)
        for d2 in range(3):
            w = -dt / (4.0 * spacing[d] * spacing[d2])
            m = _component(tensor, d, d2)
            if d != d2:
                at(e(d, 1), e(d2, 1)).add_(m, alpha=w)
                at(e(d, -1), e(d2, -1)).add_(m, alpha=w)
                at(e(d, 1), e(d2, -1)).add_(m, alpha=-w)
                at(e(d, -1), e(d2, 1)).add_(m, alpha=-w)
            t = _difference(m, d2)
            at(e(d, 1)).add_(t, alpha=w)
            at(e(d, -1)).add_(t, alpha=-w)
    for d in range(3):
        for side, step in ((0, -1), (shape[d] - 1, 1)):
            for off in OFFSETS:
                if off[d] != step:
                    continue
                mirror = list(off)
                mirror[d] = -step
                src = c[INDEX[off]].narrow(d, side, 1)
                c[INDEX[tuple(mirror)]].narrow(d, side, 1).add_(src)
                src.zero_()
    return c


def apply(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A x``, with ``x`` zero outside the grid."""
    xp = F.pad(x[None, None], (1, 1, 1, 1, 1, 1))[0, 0]
    z, y, w = x.shape
    out = c[CENTRE] * x
    for k, (dz, dy, dx) in enumerate(OFFSETS):
        if k != CENTRE:
            out.addcmul_(c[k], xp[1 + dz:1 + dz + z, 1 + dy:1 + dy + y, 1 + dx:1 + dx + w])
    return out


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sum(a * b))


def bicgstab(c: torch.Tensor, b: torch.Tensor, x: torch.Tensor, tol: float,
             max_iter: int) -> Tuple[torch.Tensor, float]:
    """Solve ``A x = b`` from ``x``; returns the best iterate and its relative
    residual (recomputed, not the recurrence's)."""
    inv_diag = 1.0 / c[CENTRE]
    b_norm = _dot(b, b) ** 0.5
    r = b - apply(c, x)
    r_hat = r.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = 1.0
    best, best_res = x.clone(), _dot(r, r) ** 0.5 / b_norm
    for _ in range(max_iter):
        if best_res <= tol:
            break
        rho_new = _dot(r_hat, r)
        if rho_new == 0.0 or omega == 0.0:
            break
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        y = p * inv_diag
        v = apply(c, y)
        denom = _dot(r_hat, v)
        if denom == 0.0:
            break
        alpha = rho_new / denom
        s = r - alpha * v
        z = s * inv_diag
        t = apply(c, z)
        tt = _dot(t, t)
        omega = _dot(t, s) / tt if tt > 0.0 else 0.0
        x = x + alpha * y + omega * z
        r = s - omega * t
        rho = rho_new
        res = _dot(r, r) ** 0.5 / b_norm
        if not res == res:  # a NaN: the iteration broke down
            break
        if res < best_res:
            best, best_res = x.clone(), res
        del y, z, s, t
    true_r = b - apply(c, best)
    return best, _dot(true_r, true_r) ** 0.5 / b_norm


def relative_residual(c: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    """``||b - A x|| / ||b||``, in ``c``'s dtype."""
    r = b - apply(c, x)
    return (_dot(r, r) / _dot(b, b)) ** 0.5


def implicit_steps(u: torch.Tensor, tensor: torch.Tensor, settings: Dict, steps: int,
                   dtype=torch.float64, tol: float = 1e-10, max_iter: int = 200):
    """``steps`` implicit Euler steps of ``u`` under ``tensor`` (dt =
    ``settings['time_step']``), computed in ``dtype``: the last step's
    solution, its right-hand side and the operator's planes."""
    c = assemble(tensor.to(dtype), settings["time_step"])
    x = rhs = u.to(dtype)
    for _ in range(steps):
        rhs = x
        x, _ = bicgstab(c, rhs, rhs.clone(), tol, max_iter)
    return x, rhs, c
