"""The assembly kernel: all 10 compressed-DCA planes from the 6 tensor planes
in one pass (``csrc/assemble_compressed.cu``).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_assemble``
(``pallas_assemble_compressed_dca``).  The kernel computes the z-border
planes itself, so the JAX package's XLA patch of those planes has no
counterpart here.  The wrapper takes the plain version
(:func:`.compressed.assemble_compressed_dca`) for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.

``cuda_assemble_compressed_dca.launches`` counts launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .compressed import CompressedDCAOperator, assemble_compressed_dca


def cuda_assemble_compressed_dca(tensor: torch.Tensor, spacing: Tuple[float, ...],
                                 time_step: float) -> CompressedDCAOperator:
    """Assemble the 3D compressed DCA operator from the ``(6, Z, Y, X)``
    tensor stack (semantics of :func:`.compressed.assemble_compressed_dca`)."""
    if tensor.device.type == "cpu":
        return assemble_compressed_dca(tensor, spacing, time_step)
    require_cuda("cuda_assemble_compressed_dca", tensor)
    if tensor.dim() != 4 or tensor.shape[0] != 6 or len(spacing) != 3:
        raise ValueError(
            "cuda_assemble_compressed_dca: needs a (6, Z, Y, X) tensor stack and "
            f"3 spacings, got {tuple(tensor.shape)} and {tuple(spacing)}"
        )
    shape = tuple(tensor.shape[1:])
    if min(shape) < 3 or shape[0] > 65535:
        raise ValueError(f"cuda_assemble_compressed_dca: unsupported shape {shape}")
    dt = float(time_step)
    h = tuple(float(s) for s in spacing)
    w2 = [-dt / (h[d] * h[d]) for d in range(3)]
    wd = [-dt / (4.0 * h[d] * h[d2]) for d in range(3) for d2 in range(3)]
    out = torch.empty((10, *shape), dtype=tensor.dtype, device=tensor.device)
    err = kernel("mad_assemble_compressed", tensor.dtype)(
        tensor.data_ptr(), out.data_ptr(), *shape, *w2, *wd, stream_of(tensor),
    )
    check_launch(err, "cuda_assemble_compressed_dca")
    cuda_assemble_compressed_dca.launches += 1
    return CompressedDCAOperator(out, 3)


cuda_assemble_compressed_dca.launches = 0
