"""Carry state across from the JAX package, as numpy arrays.

No JAX counterpart.  Nothing here imports jax: the inputs are what
``jax.device_get`` returns for the JAX package's objects (the same classes,
with numpy leaves), read by attribute.  With these, a test runs the port's
cycles on exactly the operators the JAX package built.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.stencil import StencilOperator
from ..models.mad import Hierarchy, MADConfig
from ..models.ved import VEDConfig
from ..ops.coarse import CoarseSolver
from ..ops.compressed import CompressedDCAOperator
from ..ops.matfree import MatrixFreeDCAOperator


def _t(a, dtype=None, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device).to(dtype=dtype)


def tensor_from_numpy(planes, dtype=None, device=None) -> torch.Tensor:
    """The JAX package's tensor-plane tuple -> the port's ``(S, *shape)``
    stack."""
    return torch.stack([_t(p, dtype, device) for p in planes]).contiguous()


def operator_from_numpy(op, dtype=None, device=None):
    """A JAX ``CompressedDCAOperator`` (``face_p``/``face_m``/``mixed``/
    ``diag_plane``), ``MatrixFreeDCAOperator`` (``tensor`` planes,
    ``spacing``, ``time_step``) or ``StencilOperator`` (``coeffs``/
    ``offsets``) with numpy leaves -> the port's operator."""
    if hasattr(op, "time_step"):
        return MatrixFreeDCAOperator(tensor_from_numpy(op.tensor, dtype, device),
                                     op.spacing, op.time_step)
    if hasattr(op, "face_p"):
        ndim = len(op.face_p)
        planes = []
        for d in range(ndim):
            planes += [op.face_p[d], op.face_m[d]]
        planes += list(op.mixed) + [op.diag_plane]
        return CompressedDCAOperator(tensor_from_numpy(planes, dtype, device), ndim)
    return StencilOperator(tensor_from_numpy(op.coeffs, dtype, device), op.offsets)


def solver_from_numpy(solver, dtype=None, device=None) -> CoarseSolver:
    """A JAX ``CoarseSolver`` with numpy leaves -> the port's.  JAX's pivots
    are 0-based; ``torch.linalg.lu_solve`` takes LAPACK's 1-based ones."""
    return CoarseSolver(
        inv=_t(solver.inv, dtype, device),
        lu=_t(solver.lu, dtype, device),
        piv=_t(np.asarray(solver.piv) + 1, torch.int32, device),
        inv_ok=bool(np.asarray(solver.inv_ok)),
        shape=tuple(solver.shape),
    )


def halo_from_jax(halo: str) -> str:
    """The JAX package's ``halo`` -> the port's: ``'gspmd'`` (XLA's
    partitioner, no counterpart) becomes ``'overlap'``, the same math."""
    return "overlap" if halo == "gspmd" else halo


def mad_config_from_jax(cfg) -> MADConfig:
    """A JAX ``MADConfig`` -> the port's, field by field (read by attribute):
    ``use_pallas`` becomes ``use_kernels``, the deprecated ``matrix_free``
    alias becomes ``operator_repr='matrix_free'``, ``halo`` goes through
    :func:`halo_from_jax`."""
    kw = {}
    for f in dataclasses.fields(MADConfig):
        if f.name == "use_kernels":
            kw[f.name] = cfg.use_pallas
        elif f.name == "operator_repr":
            kw[f.name] = "matrix_free" if cfg.matrix_free else cfg.operator_repr
        elif f.name == "halo":
            kw[f.name] = halo_from_jax(cfg.halo)
        else:
            kw[f.name] = getattr(cfg, f.name)
    return MADConfig(**kw)


def ved_config_from_jax(cfg) -> VEDConfig:
    """A JAX ``VEDConfig`` -> the port's, field by field (read by attribute):
    ``use_pallas`` becomes ``use_kernels``, ``halo`` goes through
    :func:`halo_from_jax`."""
    kw = {}
    for f in dataclasses.fields(VEDConfig):
        src = "use_pallas" if f.name == "use_kernels" else f.name
        value = getattr(cfg, src)
        if f.name == "scales":
            value = tuple(value)
        elif f.name == "halo":
            value = halo_from_jax(value)
        kw[f.name] = value
    return VEDConfig(**kw)


def best_from_numpy(resp, h_planes, dtype=None, device=None):
    """The JAX package's running best ``(response, hessian plane tuple)`` ->
    the ``(resp, (6, *shape) h)`` pair that ``ops.cuda_vesselness``
    takes.  ``dtype`` sets the Hessian's storage dtype; the response keeps
    its own."""
    return (_t(resp, None, device).contiguous(),
            tensor_from_numpy(h_planes, dtype, device))


def hierarchy_from_numpy(hier, dtype=None, device=None) -> Hierarchy:
    """A JAX ``Hierarchy`` after ``jax.device_get`` -> the port's
    :class:`Hierarchy` on ``device`` (in ``dtype`` if given)."""
    return Hierarchy(
        operators=tuple(operator_from_numpy(op, dtype, device) for op in hier.operators),
        solver=solver_from_numpy(hier.solver, dtype, device),
    )
