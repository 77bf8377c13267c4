"""The VED vesselness pipeline's per-voxel kernels (``csrc/vesselness.cu``):
the per-scale FD Hessian + eigenvalues + vesselness + running best-select
(B8), the final tensor assembly (B9), and the standalone FD Hessian of
``hessian(mode='smooth_fd')`` (B11), which shares B8's FD stencil.

Counterpart of ``multigridanisotropicdiffusion_tpu.ops.pallas_vesselness``
(``pallas_fd_vesselness``, ``pallas_tensor_assembly``) and of
``pallas_fd_hessian`` in ``multigridanisotropicdiffusion_tpu.ops.pallas_conv``,
with ``acos`` where the TPU kernels use ``acos_poly`` and without their
shape gates.

The plain versions take the formulas from ``models/ved.py`` as the JAX
kernels do (``measure_fn``, ``assemble_fn``), so each formula has one source
in Python; the CUDA kernels carry the same formulas in C++.

The running best is ``(resp, h)``: the response ``(Z, Y, X)`` in the compute
dtype (float32 for float32 and bf16 storage, float64 for float64) and the
winning Hessian ``(6, Z, Y, X)`` in the storage dtype.  :func:`fd_vesselness`
updates it IN PLACE on every device (the select is pointwise, so the kernel
can) and returns it.  ``fd_vesselness.launches``,
``tensor_assembly.launches`` and ``fd_hessian.launches`` count kernel
launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.stencil import compute_dtype
from ..utils.build import check_launch, kernel, require_cuda, stream_of
from .eigen3 import eigvalsh3, sort_by_abs3
from .hessian import fd_planes

Best = Tuple[torch.Tensor, torch.Tensor]


def fd_vesselness_plain(us: torch.Tensor, facs, params, best: Best | None,
                        measure_fn) -> Best:
    """Plain version of the B8 kernel, as new tensors.  ``us``: the valid-z
    smoothed field ``(Z + 2, Y, X)``; ``facs``: ``hessian.fd_factors``;
    ``params``: ``(alpha, beta, gamma)``; ``best``: the running best or
    ``None`` on the first scale (which always initializes it)."""
    h = fd_planes(us, facs)  # compute dtype: the eigensolve sees it unrounded
    resp = measure_fn(sort_by_abs3(eigvalsh3(h)), *params)
    h_store = h.to(us.dtype)
    if best is None:
        return resp, h_store
    best_resp, best_h = best
    better = resp > best_resp
    return torch.where(better, resp, best_resp), torch.where(better, h_store, best_h)


def fd_hessian_plain(us: torch.Tensor, facs) -> torch.Tensor:
    """Plain version of the B11 kernel: the six FD planes of the valid-z
    smoothed field ``(Z + 2, Y, X)``, rounded to its storage dtype."""
    return fd_planes(us, facs).to(us.dtype)


def tensor_assembly_plain(resp: torch.Tensor, h: torch.Tensor,
                          assemble_fn) -> torch.Tensor:
    """Plain version of the B9 kernel: ``assemble_fn(resp, h)`` on the
    Hessian in the response's dtype; a ``(6, Z, Y, X)`` tensor stack."""
    return assemble_fn(resp, h.to(resp.dtype))


def _fd_output_shape(name: str, us: torch.Tensor) -> Tuple[int, ...]:
    """The ``(Z, Y, X)`` output of an FD kernel on the CUDA field ``us``
    ``(Z + 2, Y, X)``; raises on what the kernels do not take."""
    require_cuda(name, us)
    if us.dim() != 3 or us.shape[0] < 3:
        raise ValueError(f"{name}: needs a (Z + 2, Y, X) field, got "
                         f"{tuple(us.shape)}")
    shape = (us.shape[0] - 2, *us.shape[1:])
    if shape[0] > 65535:
        raise ValueError(f"{name}: Z of {shape} exceeds the launch limit")
    return shape


def _check_fdv(us: torch.Tensor, best: Best | None) -> Tuple[int, ...]:
    shape = _fd_output_shape("fd_vesselness", us)
    if best is not None:
        resp, h = best
        require_cuda("fd_vesselness", h, us)
        require_cuda("fd_vesselness", resp)
        if tuple(resp.shape) != shape or tuple(h.shape) != (6, *shape):
            raise ValueError(f"fd_vesselness: best {tuple(resp.shape)} / "
                             f"{tuple(h.shape)} does not match {shape}")
        if resp.dtype != compute_dtype(us.dtype) or resp.device != us.device:
            raise TypeError(f"fd_vesselness: best response is {resp.dtype} on "
                            f"{resp.device}, expected {compute_dtype(us.dtype)}")
    return shape


def fd_vesselness(us: torch.Tensor, facs, params, best: Best | None = None,
                  measure_fn=None) -> Best:
    """One scale of the fused pipeline: returns the running best, updated in
    place (allocated on the first scale).  ``measure_fn`` (the vesselness
    formula, ``models.ved.vesselness_measure``) is what the plain version
    runs on a CPU tensor; the kernel has the formula compiled in."""
    if us.device.type == "cpu":
        if measure_fn is None:
            raise ValueError("fd_vesselness: the plain version needs measure_fn")
        resp, h = fd_vesselness_plain(us, facs, params, best, measure_fn)
        if best is None:
            return resp, h
        best[0].copy_(resp)
        best[1].copy_(h)
        return best
    shape = _check_fdv(us, best)
    first = best is None
    if first:
        best = (torch.empty(shape, dtype=compute_dtype(us.dtype), device=us.device),
                torch.empty((6, *shape), dtype=us.dtype, device=us.device))
    alpha, beta, gamma = (float(p) for p in params)
    err = kernel("mad_fd_vesselness", us.dtype)(
        us.data_ptr(), best[0].data_ptr(), best[1].data_ptr(), *shape,
        *(float(f) for f in facs), 2.0 * alpha * alpha, 2.0 * beta * beta,
        2.0 * gamma * gamma, int(first), stream_of(us),
    )
    check_launch(err, "fd_vesselness")
    fd_vesselness.launches += 1
    return best


fd_vesselness.launches = 0


def tensor_assembly(resp: torch.Tensor, h: torch.Tensor, epsilon: float,
                    omega: float, sensitivity: float,
                    assemble_fn=None) -> torch.Tensor:
    """The diffusion tensor ``(6, Z, Y, X)``, in the response's dtype, from
    the winning response and Hessian.  ``assemble_fn``
    (``models.ved._make_assemble_fn(epsilon, omega, sensitivity)``) is what
    the plain version runs on a CPU tensor."""
    if resp.device.type == "cpu":
        if assemble_fn is None:
            raise ValueError("tensor_assembly: the plain version needs assemble_fn")
        return tensor_assembly_plain(resp, h, assemble_fn)
    require_cuda("tensor_assembly", h)
    require_cuda("tensor_assembly", resp)
    if tuple(h.shape) != (6, *resp.shape) or resp.device != h.device:
        raise ValueError(f"tensor_assembly: h {tuple(h.shape)} does not match "
                         f"resp {tuple(resp.shape)}")
    if resp.dtype != compute_dtype(h.dtype):
        raise TypeError(f"tensor_assembly: resp {resp.dtype} for h {h.dtype}")
    out = torch.empty((6, *resp.shape), dtype=resp.dtype, device=resp.device)
    err = kernel("mad_tensor_assembly", h.dtype)(
        resp.data_ptr(), h.data_ptr(), out.data_ptr(), resp.numel(),
        1.0 / float(sensitivity), float(epsilon) - 1.0,
        float(omega) - float(epsilon), stream_of(resp),
    )
    check_launch(err, "tensor_assembly")
    tensor_assembly.launches += 1
    return out


tensor_assembly.launches = 0


def fd_hessian(us: torch.Tensor, facs) -> torch.Tensor:
    """The ``(6, Z, Y, X)`` central-difference Hessian of a valid-z smoothed
    field ``(Z + 2, Y, X)`` (1-plane z halo; y and x replicate their edges),
    in its storage dtype.  ``facs``: ``hessian.fd_factors``."""
    if us.device.type == "cpu":
        return fd_hessian_plain(us, facs)
    shape = _fd_output_shape("fd_hessian", us)
    out = torch.empty((6, *shape), dtype=us.dtype, device=us.device)
    err = kernel("mad_fd_hessian", us.dtype)(
        us.data_ptr(), out.data_ptr(), *shape, *(float(f) for f in facs),
        stream_of(us),
    )
    check_launch(err, "fd_hessian")
    fd_hessian.launches += 1
    return out


fd_hessian.launches = 0
