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

Distributed over ``torch.distributed`` ranks (one device each; every rank
runs the same program with the whole input and gets back its block):

    madt.initialize_multihost()          # torchrun's env://, or explicit
    mesh = madt.make_grid_mesh(3)        # or make_multihost_grid_mesh(3)
    res = madt.mad_diffusion(image, tensor, config=cfg, mesh=mesh)
    out = madt.gather_field(res.output, mesh)   # the whole volume
"""

from .core.grids import CELL, VERTEX, GridLevel, build_level_descriptors
from .core.stencil import StencilOperator, apply_stencil, l2_norm, residual, stencil_offsets
from .core.symfield import as_sym_planes, sym_from_matrix, sym_pairs, sym_to_matrix
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
from .parallel.sharding import (
    DEFAULT_MIN_LOCAL,
    GridMesh,
    factorize_devices,
    gather_field,
    initialize_multihost,
    level_spec,
    make_grid_mesh,
    make_multihost_grid_mesh,
    shard_field,
)

__version__ = "0.1.0"

__all__ = [
    "CELL", "DCA", "DEFAULT_MIN_LOCAL", "FMG", "GALERKIN", "SMOOTHER", "VCYCLE",
    "VERTEX", "GridLevel", "GridMesh", "Hierarchy", "MADConfig", "MADResult",
    "MatrixFreeDCAOperator", "MultigridAnisotropicDiffusionImageFilter",
    "StencilOperator", "VEDConfig", "VEDMultigridImageFilter", "VEDResult",
    "apply_stencil", "as_sym_planes", "assemble_dca", "assemble_galerkin",
    "build_hierarchy", "build_level_descriptors", "factorize_devices", "gather_field",
    "initialize_multihost", "jacobi_sweep", "l2_norm", "level_spec", "mad_diffusion",
    "make_grid_mesh", "make_multihost_grid_mesh", "prolong", "rb_gauss_seidel_sweep",
    "residual", "restrict", "shard_field", "stencil_offsets", "sym_from_matrix", "sym_pairs",
    "sym_to_matrix", "ved",
]
