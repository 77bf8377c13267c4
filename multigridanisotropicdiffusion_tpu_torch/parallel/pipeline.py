"""The VED vesselness pipeline on z slabs of a distributed run.

Counterpart of ``multigridanisotropicdiffusion_tpu.parallel.pipeline``.  The
pipeline needs halos as thick as the largest Gaussian radius (plus the
finite-difference shell), which the kernels take natively only along z, their
valid-mode axis.  So the pipeline runs on a 1-D z-slab decomposition over the
same ranks (rank r holds slab r):

1. every rank holds the whole volume, so it cuts its slab with ``halo``
   planes on either side straight from it, edge-replicated at the global
   borders (the single-device pipeline pads the volume with ``mode='edge'``):
   nothing is exchanged,
2. the port's slab function (``models.ved._fused_scales``: B6 -> B7 -> B8 per
   scale, then B9, for ``smooth_fd`` with the kernels; B6/B10 Hessians ->
   B15 per scale, then B9, for ``gaussian_derivative``) runs on the extended
   slab in valid-z mode,
3. one all-gather assembles the response and the six tensor planes on every
   rank: the solve's setup runs replicated, from the whole tensor.

:func:`make_sharded_vesselness_pipeline` returns None where the z extent
does not split into equal slabs at least ``halo`` thick; the caller then runs
the single-device pipeline on the whole volume.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.stencil import compute_dtype
from .sharding import GridMesh, gather_ranks


def pipeline_halo(scales: Sequence[float], spacing: Sequence[float],
                  hessian_mode: str = "smooth_fd") -> int:
    """z planes each slab needs from its neighbours: the largest Gaussian
    radius, plus the finite-difference shell in ``smooth_fd`` mode (the
    halo of the single-device z tiling)."""
    from ..ops.hessian import kernel_radius

    radius = max(kernel_radius(float(s), float(spacing[0])) for s in scales)
    return radius + 1 if hessian_mode == "smooth_fd" else radius


def make_sharded_vesselness_pipeline(
    shape: Tuple[int, ...],
    mesh: GridMesh,
    scales: Sequence[float],
    spacing: Sequence[float],
    alpha: float,
    beta: float,
    gamma: float,
    epsilon: float,
    omega: float,
    sensitivity: float,
    hessian_mode: str = "smooth_fd",
    pipeline_dtype=None,
    use_kernels: bool = False,
    z_slab: int | None = None,
):
    """``pipeline(u) -> (response, tensor)``: ``u`` the whole volume on every
    rank, the outputs whole on every rank, in the math dtype.  None when the
    shape does not split into z slabs.  ``z_slab`` tiles each rank's slab
    further (``models.ved._auto_z_slab``), so the temporaries stay
    O(tile)."""
    from ..models.mad import torch_dtype
    from ..models.ved import _fused_scales

    if len(shape) != 3:
        return None
    n, rank = mesh.size, mesh.rank
    nz = shape[0]
    halo = pipeline_halo(scales, spacing, hessian_mode)
    if nz % n or nz // n < halo:
        return None
    local = nz // n
    args = (tuple(scales), tuple(spacing), alpha, beta, gamma, epsilon, omega, sensitivity,
            halo, hessian_mode, use_kernels)

    def pipeline(u: torch.Tensor):
        if pipeline_dtype is not None:
            u = u.to(torch_dtype(pipeline_dtype))
        z0 = rank * local
        planes = torch.arange(z0 - halo, z0 + local + halo, device=u.device).clamp_(0, nz - 1)
        ext = u.index_select(0, planes)
        if z_slab is None or z_slab >= local:
            resp, t = _fused_scales(ext, *args)
        else:
            if local % z_slab:
                raise ValueError(f"z_slab {z_slab} must divide the slab of {local} planes")
            cd = compute_dtype(ext.dtype)
            resp = torch.empty((local, *ext.shape[1:]), dtype=cd, device=ext.device)
            t = torch.empty((6, local, *ext.shape[1:]), dtype=cd, device=ext.device)
            for t0 in range(0, local, z_slab):
                r_, t_ = _fused_scales(ext[t0:t0 + z_slab + 2 * halo], *args)
                resp[t0:t0 + z_slab], t[:, t0:t0 + z_slab] = r_, t_
                del r_, t_
        del ext
        return gather_ranks(resp, mesh, 0), gather_ranks(t, mesh, 1)

    return pipeline
