"""Coarsest-grid direct solve.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.coarse``.  The
coarsest level is tiny (every dimension in [6, 11], N <= 1331 in 3D): the
stored operator is densified, LU-factorized once at setup, and each visit
applies the precomputed inverse (``lu_solve`` of the identity) as one
``N x N`` matvec.  A conditioning proxy guards that shortcut: when
``min|diag(U)| / max|diag(U)|`` of the LU says the operator is
pathologically conditioned, visits back-substitute through the LU instead.
The JAX package decides this inside its traced program with ``lax.cond``;
here the proxy is evaluated once on the host at setup.

The matvec is plain ``torch.matmul`` (the JAX package leaves it to XLA).  On
CUDA, :func:`build_coarse_solver` turns TF32 off for matmuls and cuDNN so
that a float32 matvec runs in full float32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.stencil import StencilOperator, densify

#: rcond proxy below which the precomputed-inverse matvec is not trusted.
_RCOND_PROXY_FLOOR = 1e4


class CoarseSolver(NamedTuple):
    """Precomputed inverse of the coarsest operator plus its LU."""

    inv: torch.Tensor
    lu: torch.Tensor
    #: LAPACK-style 1-based pivots, as ``torch.linalg.lu_factor`` returns them.
    piv: torch.Tensor
    #: host-side: the conditioning proxy cleared the floor, so visits use
    #: the inverse matvec (else ``lu_solve``).
    inv_ok: bool
    shape: Tuple[int, ...]


def inverse_trusted(lu: torch.Tensor) -> bool:
    """The conditioning proxy, evaluated on the host."""
    d = torch.abs(torch.diagonal(lu))
    eps = torch.finfo(lu.dtype).eps
    return bool(torch.min(d) > _RCOND_PROXY_FLOOR * lu.shape[0] * eps * torch.max(d))


def build_coarse_solver(op: StencilOperator) -> CoarseSolver:
    if op.coeffs.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    a = densify(op)
    lu, piv = torch.linalg.lu_factor(a)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    inv = torch.linalg.lu_solve(lu, piv, eye)
    return CoarseSolver(inv=inv, lu=lu, piv=piv, inv_ok=inverse_trusted(lu),
                        shape=op.shape)


def coarse_solve(solver: CoarseSolver, b: torch.Tensor) -> torch.Tensor:
    """Solve on the coarsest level; a low-precision rhs (mixed-precision
    defect cycles) is solved in the setup precision and cast back."""
    rhs = b.reshape(-1).to(solver.inv.dtype)
    if solver.inv_ok:
        x = solver.inv @ rhs
    else:
        x = torch.linalg.lu_solve(solver.lu, solver.piv, rhs[:, None])[:, 0]
    return x.reshape(b.shape).to(b.dtype)
