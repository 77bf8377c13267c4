"""PyTorch/CUDA port of the multigrid anisotropic-diffusion solver.

Counterpart of ``multigridanisotropicdiffusion_tpu`` (the JAX reference),
module for module.  Importing this package needs only torch and numpy: the
CUDA kernels (``ops/cuda_*.py``) are built and loaded at their first launch
on a CUDA tensor, never at import.

    import torch
    import multigridanisotropicdiffusion_tpu_torch as madt

    cfg = madt.MADConfig.cuda(time_step=0.1, tolerance=1e-6)
    res = madt.mad_diffusion(image, tensor, config=cfg, device="cuda")
"""

from .models.mad import MADConfig, MADResult, mad_diffusion

__all__ = ["MADConfig", "MADResult", "mad_diffusion"]
