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
"""

from .models.mad import MADConfig, MADResult, mad_diffusion
from .models.ved import VEDConfig, VEDResult, ved

__all__ = ["MADConfig", "MADResult", "VEDConfig", "VEDResult", "mad_diffusion",
           "ved"]
