"""The 1-D correlation kernels of the VED pipeline (``csrc/conv.cu``): along
z (B6), the fused y-then-x smoothing (B7), and the single-axis passes along
y and x (B10) of ``hessian(mode='gaussian_derivative')``.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_conv``
(``pallas_conv_z``, ``pallas_conv_yx``, ``pallas_conv_y``,
``pallas_conv_x``), without its banded-matmul formulation, z padding and
lane/granule gates: the kernels take any shape.  Valid mode is z-only, as
the JAX package's ``pallas_conv_supported`` has it.

Semantics (``ops.hessian._conv_axis``): ``out[i] = sum_j k[j] u[i + j - r]``
along the axis, edge-replicated at the borders, or in ``valid`` mode over an
input that already carries the r-thick halos (the output is 2r shorter).
The taps are summed in ascending ``j`` with zero taps skipped, in the
compute dtype (float32 for bf16 storage), and every pass rounds once to the
storage dtype at its store; the fused y+x pass rounds once, after x.

Each wrapper takes the plain PyTorch version for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.  ``conv_z.launches``,
``conv_yx.launches``, ``conv_y.launches`` and ``conv_x.launches`` count
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.stencil import compute_dtype
from ..utils.build import check_launch, kernel, require_cuda, stream_of

#: ``kernel_radius`` caps the radius at 64, so a kernel has at most 129 taps
MAX_TAPS = 129


def edge_pad(u: torch.Tensor, r: int, axis: int = 0) -> torch.Tensor:
    """``u`` with ``r`` edge-replicated planes on each side of ``axis``."""
    n = u.shape[axis]
    idx = torch.arange(-r, n + r, device=u.device).clamp_(0, n - 1)
    return u.index_select(axis, idx)


def conv_axis_plain(u: torch.Tensor, taps, axis: int, valid: bool = False,
                    round_result: bool = True) -> torch.Tensor:
    """Correlate ``u`` with the 1-D ``taps`` along ``axis`` as a sum of
    shifted slices.  ``round_result=False`` keeps the compute dtype (the
    fused y+x pass rounds once, after x)."""
    k = np.asarray(taps, np.float64)
    r = (len(k) - 1) // 2
    n = u.shape[axis]
    if valid:
        n -= 2 * r
        up = u
    else:
        up = edge_pad(u, r, axis)
    cd = compute_dtype(u.dtype)
    out = None
    for j in range(len(k)):
        if k[j] == 0.0:  # zero-padded taps (the z-slab pipeline) cost nothing
            continue
        term = float(k[j]) * up.narrow(axis, j, n).to(cd)
        out = term if out is None else out + term
    return out.to(u.dtype) if round_result else out


def conv_z_plain(u: torch.Tensor, taps, valid: bool = False) -> torch.Tensor:
    """Plain version of the z kernel."""
    return conv_axis_plain(u, taps, 0, valid)


def conv_y_plain(u: torch.Tensor, taps) -> torch.Tensor:
    """Plain version of the y kernel (edge-replicated, rounded)."""
    return conv_axis_plain(u, taps, 1)


def conv_x_plain(u: torch.Tensor, taps) -> torch.Tensor:
    """Plain version of the x kernel (edge-replicated, rounded)."""
    return conv_axis_plain(u, taps, 2)


def conv_yx_plain(u: torch.Tensor, taps_y, taps_x) -> torch.Tensor:
    """Plain version of the fused y+x kernel: the y pass stays in the
    compute dtype, the x pass rounds once."""
    q = conv_axis_plain(u, taps_y, 1, round_result=False)
    return conv_axis_plain(q, taps_x, 2, round_result=False).to(u.dtype)


def _host_taps(taps, dtype: torch.dtype) -> np.ndarray:
    """The taps as a host array of the kernel's compute type, padded to
    MAX_TAPS (the C side copies them into the launch's parameters)."""
    k = np.asarray(taps, np.float64)
    if k.ndim != 1 or len(k) % 2 == 0 or len(k) > MAX_TAPS:
        raise ValueError(f"taps must be an odd-length vector of at most "
                         f"{MAX_TAPS}, got shape {k.shape}")
    host = np.zeros(MAX_TAPS, np.float64 if dtype == torch.float64 else np.float32)
    host[:len(k)] = k
    return host


def _check(name: str, u: torch.Tensor) -> None:
    require_cuda(name, u)
    if u.dim() != 3:
        raise ValueError(f"{name}: needs a (Z, Y, X) field, got {tuple(u.shape)}")
    if u.shape[0] > 65535:
        raise ValueError(f"{name}: Z of {tuple(u.shape)} exceeds the launch limit")


def conv_z(u: torch.Tensor, taps, valid: bool = False) -> torch.Tensor:
    """Correlate along axis 0: edge-replicated, or (``valid``) over an input
    that carries the r-thick z halos."""
    if u.device.type == "cpu":
        return conv_z_plain(u, taps, valid)
    _check("conv_z", u)
    host = _host_taps(taps, u.dtype)
    nt = len(np.asarray(taps))
    r = (nt - 1) // 2
    zi, y, x = u.shape
    zo = zi - 2 * r if valid else zi
    if zo <= 0:
        raise ValueError(f"conv_z: {zi} planes leave no output for radius {r}")
    out = torch.empty((zo, y, x), dtype=u.dtype, device=u.device)
    err = kernel("mad_conv_z", u.dtype)(
        u.data_ptr(), out.data_ptr(), zi, y, x, zo, host.ctypes.data, nt,
        int(valid), stream_of(u),
    )
    check_launch(err, "conv_z")
    conv_z.launches += 1
    return out


conv_z.launches = 0


def conv_yx(u: torch.Tensor, taps_y, taps_x) -> torch.Tensor:
    """Edge-replicated correlation along axis 1, then axis 2, in one pass."""
    if u.device.type == "cpu":
        return conv_yx_plain(u, taps_y, taps_x)
    _check("conv_yx", u)
    hy, hx = _host_taps(taps_y, u.dtype), _host_taps(taps_x, u.dtype)
    out = torch.empty_like(u)
    err = kernel("mad_conv_yx", u.dtype)(
        u.data_ptr(), out.data_ptr(), *u.shape, hy.ctypes.data,
        len(np.asarray(taps_y)), hx.ctypes.data, len(np.asarray(taps_x)),
        stream_of(u),
    )
    check_launch(err, "conv_yx")
    conv_yx.launches += 1
    return out


conv_yx.launches = 0


def _launch_axis(name: str, u: torch.Tensor, taps) -> torch.Tensor:
    """Launch the single-axis tile kernel ``mad_<name>`` (B10) on a CUDA
    tensor."""
    _check(name, u)
    host = _host_taps(taps, u.dtype)
    out = torch.empty_like(u)
    err = kernel(f"mad_{name}", u.dtype)(
        u.data_ptr(), out.data_ptr(), *u.shape, host.ctypes.data,
        len(np.asarray(taps)), stream_of(u),
    )
    check_launch(err, name)
    return out


def conv_y(u: torch.Tensor, taps) -> torch.Tensor:
    """Edge-replicated correlation along axis 1, rounded to the storage
    dtype."""
    if u.device.type == "cpu":
        return conv_y_plain(u, taps)
    out = _launch_axis("conv_y", u, taps)
    conv_y.launches += 1
    return out


conv_y.launches = 0


def conv_x(u: torch.Tensor, taps) -> torch.Tensor:
    """Edge-replicated correlation along axis 2, rounded to the storage
    dtype."""
    if u.device.type == "cpu":
        return conv_x_plain(u, taps)
    out = _launch_axis("conv_x", u, taps)
    conv_x.launches += 1
    return out


conv_x.launches = 0
