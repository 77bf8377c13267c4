"""The 3D transfer kernels: restriction and prolongation for every centring
(``csrc/transfer.cu``).

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_transfer``
(``pallas_restrict3d``, ``pallas_prolong3d``), without their all-cell,
X % 256 gate.  The kernels read per-axis tap tables built on the host from
the 1-D transfer matrices (:func:`.transfer.restrict_taps`,
:func:`.transfer.prolong_taps`) and cached on the device per shape.  A
leading batch axis is allowed: ``(B, Z, Y, X)`` restricts B fields in one
launch.  Each wrapper takes the plain version for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.

``cuda_restrict.launches`` and ``cuda_prolong.launches`` count launches.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..core.stencil import compute_dtype
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .transfer import (
    coarse_size,
    fine_size,
    prolong_plain,
    prolong_taps,
    restrict_plain,
    restrict_taps,
)


@functools.lru_cache(maxsize=128)
def _device_tables(kind: str, fine_shape: Tuple[int, ...],
                   centering: Tuple[str, ...], weight_dtype: torch.dtype,
                   device: torch.device):
    """Per-axis (start, weights) tables on ``device``, as two flat tensors
    plus each axis's offset into them."""
    taps = restrict_taps if kind == "restrict" else prolong_taps
    tables = [taps(n, c) for n, c in zip(fine_shape, centering)]
    starts = torch.as_tensor(np.concatenate([s for s, _ in tables]),
                             dtype=torch.int32, device=device)
    weights = torch.as_tensor(np.concatenate([w.ravel() for _, w in tables]),
                              dtype=weight_dtype, device=device)
    s_off = np.cumsum([0] + [len(s) for s, _ in tables[:-1]]).tolist()
    w_off = np.cumsum([0] + [w.size for _, w in tables[:-1]]).tolist()
    return starts, weights, s_off, w_off


def _table_pointers(kind, fine_shape, centering, dtype, device):
    starts, weights, s_off, w_off = _device_tables(
        kind, tuple(fine_shape), tuple(centering), compute_dtype(dtype), device
    )
    sp = [starts.data_ptr() + o * starts.element_size() for o in s_off]
    wp = [weights.data_ptr() + o * weights.element_size() for o in w_off]
    return sp + wp


def _check(name: str, x: torch.Tensor, centering) -> None:
    require_cuda(name, x)
    if len(centering) != 3 or x.dim() not in (3, 4):
        raise ValueError(
            f"{name}: the kernel takes (Z, Y, X) or (B, Z, Y, X) fields with 3 "
            f"centerings, got shape {tuple(x.shape)}, centering {centering}"
        )


def cuda_restrict(x: torch.Tensor, centering: Tuple[str, ...]) -> torch.Tensor:
    """Full-weighting restriction over the trailing three axes."""
    if x.device.type == "cpu":
        return restrict_plain(x, centering)
    _check("cuda_restrict", x, centering)
    fine = tuple(x.shape[-3:])
    coarse = tuple(coarse_size(n, c) for n, c in zip(fine, centering))
    batch = math.prod(x.shape[:-3])
    if batch * coarse[0] > 65535:
        raise ValueError(f"cuda_restrict: batch * Z of {tuple(x.shape)} too large")
    out = torch.empty((*x.shape[:-3], *coarse), dtype=x.dtype, device=x.device)
    err = kernel("mad_restrict3d", x.dtype)(
        x.data_ptr(), out.data_ptr(), batch, *fine, *coarse,
        *_table_pointers("restrict", fine, centering, x.dtype, x.device),
        stream_of(x),
    )
    check_launch(err, "cuda_restrict")
    cuda_restrict.launches += 1
    return out


cuda_restrict.launches = 0


def cuda_prolong(x: torch.Tensor, centering: Tuple[str, ...]) -> torch.Tensor:
    """Linear prolongation ``P e`` over the trailing three axes."""
    if x.device.type == "cpu":
        return prolong_plain(x, centering)
    _check("cuda_prolong", x, centering)
    coarse = tuple(x.shape[-3:])
    fine = tuple(fine_size(n, c) for n, c in zip(coarse, centering))
    batch = math.prod(x.shape[:-3])
    if batch * fine[0] > 65535:
        raise ValueError(f"cuda_prolong: batch * Z of the fine field too large")
    out = torch.empty((*x.shape[:-3], *fine), dtype=x.dtype, device=x.device)
    err = kernel("mad_prolong3d", x.dtype)(
        x.data_ptr(), out.data_ptr(), batch, *coarse, *fine,
        *_table_pointers("prolong", fine, centering, x.dtype, x.device),
        stream_of(x),
    )
    check_launch(err, "cuda_prolong")
    cuda_prolong.launches += 1
    return out


cuda_prolong.launches = 0
