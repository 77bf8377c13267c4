"""PyTorch/CUDA port of the multigrid anisotropic-diffusion solver.

Counterpart of ``multigridanisotropicdiffusion_tpu`` (the JAX reference),
module for module.  Importing this package needs only torch and numpy: the
CUDA kernels (``ops/cuda_*.py``) are built and loaded at their first launch
on a CUDA tensor, never at import.

The entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that argument they raise.

    import torch
    import multigridanisotropicdiffusion_tpu_torch as madt

    cfg = madt.MADConfig.cuda(time_step=0.1, tolerance=1e-6)
    res = madt.mad_diffusion(image, tensor, config=cfg)
    out = madt.ved(volume, config=madt.VEDConfig.cuda())

The ITK-style façades (``MultigridAnisotropicDiffusionImageFilter``,
``VEDMultigridImageFilter``) wrap the same two entry points.
"""

from .core.grids import CELL, VERTEX, GridLevel, build_level_descriptors
from .core.stencil import StencilOperator, apply_stencil, l2_norm, residual, stencil_offsets
from .core.symfield import as_sym_planes, sym_pairs
from .models.filters import MultigridAnisotropicDiffusionImageFilter, VEDMultigridImageFilter
from .models.mad import (
    DCA,
    FMG,
    GALERKIN,
    SMOOTHER,
    VCYCLE,
    Hierarchy,
    MADConfig,
    MADResult,
    build_hierarchy,
    mad_diffusion,
)
from .models.ved import VEDConfig, VEDResult, ved
from .ops.dca import assemble_dca
from .ops.galerkin import assemble_galerkin
from .ops.matfree import MatrixFreeDCAOperator
from .ops.smoothers import jacobi_sweep, rb_gauss_seidel_sweep
from .ops.transfer import prolong, restrict

__all__ = [
    "CELL", "DCA", "FMG", "GALERKIN", "SMOOTHER", "VCYCLE", "VERTEX", "GridLevel",
    "Hierarchy", "MADConfig", "MADResult", "MatrixFreeDCAOperator",
    "MultigridAnisotropicDiffusionImageFilter", "StencilOperator", "VEDConfig",
    "VEDMultigridImageFilter", "VEDResult", "apply_stencil", "as_sym_planes",
    "assemble_dca", "assemble_galerkin", "build_hierarchy", "build_level_descriptors",
    "jacobi_sweep", "l2_norm", "mad_diffusion", "prolong", "rb_gauss_seidel_sweep",
    "residual", "restrict", "stencil_offsets", "sym_pairs", "ved",
]
