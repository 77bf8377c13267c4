"""Vesselness-enhancing diffusion (VED, Manniesing et al.).

Counterpart of ``multigridanisotropicdiffusion_tpu.models.ved`` (reference
``itk::VEDMultigridImageFilter``): per outer iteration,

1. for each scale sigma: scale-normalized Gaussian Hessian, analytic 3x3
   eigenvalues, Frangi vesselness; keep the best response over scales and
   the winning Hessian,
2. the diffusion tensor ``T = Q diag(d1, d1, d3) Q^T`` of the winning
   Hessian's eigenframe, ``d1 = 1 + (eps - 1) V``, ``d3 = 1 + (omega - 1) V``,
   ``V = response^(1/sensitivity)``, the identity where ``V <= 0``,
3. ``diffusion_iterations`` implicit MAD steps with that tensor.

With ``use_kernels`` and ``hessian_mode='smooth_fd'`` (``VEDConfig.cuda()``)
every scale runs B6 (z smoothing) -> B7 (y+x smoothing) -> B8 (FD Hessian,
eigenvalues, vesselness, running select) and the tensor comes from B9
(``ops.cuda_conv``, ``ops.cuda_vesselness``).  In ``gaussian_derivative``
mode with ``use_kernels`` every scale's Hessian runs through B6 (z) and B10
(y, x), then B15 (eigenvalues, vesselness, running select; the JAX package
leaves that step to XLA), and the tensor comes from B9.  Otherwise the
generic path computes the Hessian planes, the eigenvalues and, once, the
full eigenframe.  Tensors are ``(6, *shape)`` stacks in symfield order.

Large volumes are processed in z slabs (``_auto_z_slab``): a Python loop over
slabs that writes into preallocated outputs.

With a mesh (:mod:`..parallel`) every rank receives the whole volume; the
pipeline runs on one z slab per rank, cut with its halo planes from the
volume (:mod:`..parallel.pipeline`, either Hessian mode), an all-gather
assembles its outputs for the solve's replicated setup, and the solve is the
distributed ``mad_diffusion``.  Each rank returns its blocks;
``parallel.sharding.gather_field`` assembles the volume.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.stencil import compute_dtype
from ..core.symfield import sym_pairs
from ..ops import cuda_vesselness
from ..ops.cuda_conv import edge_pad
from ..ops.eigen3 import eigh3, sort_by_abs3
from ..ops.hessian import fd_factors, hessian, kernel_radius, smoothed_field_valid_z
from ..utils.profiling import VED, VED_PIPELINE, span
from .mad import VCYCLE, MADConfig, MADResult, mad_diffusion, resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class VEDConfig:
    """Parameters mirroring the reference's setters and defaults
    (itkVEDMultigridImageFilter.hxx:34-60)."""

    alpha: float = 0.5
    beta: float = 0.5
    gamma: float = 5.0
    epsilon: float = 0.01
    omega: float = 5.0
    sensitivity: float = 10.0
    iterations: int = 1
    diffusion_iterations: int = 5
    scales: Tuple[float, ...] = (0.300, 0.482, 0.775, 1.245, 2.000)
    # MAD passthroughs (defaults per the VED ctor, not the MAD ctor).
    cycle: str = VCYCLE
    time_step: float = 0.1
    tolerance: float = 1e-6
    diffusion_iterations_per_grid: int = 2
    smoother: str = "gauss_seidel"
    max_cycles: int = 100  # hardcoded in DiffusionStep (.hxx:396)
    coarse_operator: str = "dca"
    galerkin_variant: str = "collapsed"
    galerkin_prune_tol: float = 0.0
    operator_repr: str = "stored"
    #: solve with the matrix-free operator (mad_config() maps it to
    #: operator_repr='matrix_free', as the JAX package's alias does)
    matrix_free: bool = False
    #: the pipeline's smooth_fd path and the solve run through the CUDA
    #: kernels (the JAX package's use_pallas and its TPU-backend gates)
    use_kernels: bool = False
    #: z-slab thickness of the vesselness pipeline; 0 = auto (tile large
    #: volumes), None = never tile.
    pipeline_z_slab: int | None = 0
    #: distribution strategy of the solve with a mesh (MADConfig.halo)
    halo: str = "overlap"
    #: mixed-precision defect cycles of the solve (MADConfig.defect_dtype)
    defect_dtype: str | None = None
    #: 'smooth_fd' (smooth once per scale, then central differences) or
    #: 'gaussian_derivative' (exact sampled derivative kernels per component,
    #: the reference-faithful form: with use_kernels its 1-D passes run
    #: through B6 and B10)
    hessian_mode: str = "smooth_fd"
    #: storage dtype of the pipeline's streamed fields (e.g. 'bfloat16');
    #: the math runs in float32 for 16-bit storage.  None = the solve dtype.
    pipeline_dtype: str | None = None

    def __post_init__(self):
        if self.hessian_mode not in ("smooth_fd", "gaussian_derivative"):
            raise ValueError(f"unknown hessian mode: {self.hessian_mode!r}")
        self.mad_config()  # the solver options are MADConfig's to check

    @classmethod
    def cuda(cls, mixed_precision: bool = True, **kw) -> "VEDConfig":
        """The H100 fast path, counterpart of the JAX package's
        ``VEDConfig.tpu()`` without a mesh: compressed operator, the CUDA
        kernels, and bf16 defect cycles unless ``mixed_precision=False``."""
        kw.setdefault("operator_repr", "compressed")
        kw.setdefault("use_kernels", True)
        if mixed_precision:
            kw.setdefault("defect_dtype", "bfloat16")
        return cls(**kw)

    def mad_config(self) -> MADConfig:
        return MADConfig(
            time_step=self.time_step,
            number_of_steps=self.diffusion_iterations,
            cycle=self.cycle,
            iterations_per_grid=self.diffusion_iterations_per_grid,
            tolerance=self.tolerance,
            max_cycles=self.max_cycles,
            smoother=self.smoother,
            coarse_operator=self.coarse_operator,
            galerkin_variant=self.galerkin_variant,
            galerkin_prune_tol=self.galerkin_prune_tol,
            operator_repr="matrix_free" if self.matrix_free else self.operator_repr,
            use_kernels=self.use_kernels,
            halo=self.halo,
            defect_dtype=self.defect_dtype,
        )


def vesselness_measure(eigenvalues: torch.Tensor, alpha: float, beta: float,
                       gamma: float) -> torch.Tensor:
    """Frangi-style vesselness from |value|-ascending eigenvalues ``(3, ...)``
    (reference VesselnessFunction, .hxx:176-212, with the smooth factor
    c = 1e-5); zero wherever lambda2 >= 0 or lambda3 >= 0."""
    l1, l2, l3 = eigenvalues.unbind(0)
    bright_tube = (l2 < 0) & (l3 < 0)
    smooth_c = torch.tensor(1e-5, dtype=l1.dtype)
    l2_safe = torch.where(bright_tube, l2, -1.0)
    l3_safe = torch.where(bright_tube, l3, -1.0)

    inv2 = 1.0 / l2_safe
    inv3 = 1.0 / l3_safe
    ra = l2_safe * inv3
    ra2 = ra * ra
    rb2 = (l1 * l1) * torch.abs(inv2 * inv3)
    s2 = l1 * l1 + l2 * l2 + l3 * l3

    smooth = torch.exp(-(2.0 * smooth_c * smooth_c) * torch.abs(inv2) * (inv3 * inv3))
    v = (
        smooth
        * (1.0 - torch.exp(-ra2 / (2.0 * alpha * alpha)))
        * torch.exp(-rb2 / (2.0 * beta * beta))
        * (1.0 - torch.exp(-s2 / (2.0 * gamma * gamma)))
    )
    return torch.where(bright_tube, v, 0.0)


def max_vesselness_over_scales(u: torch.Tensor, scales: Sequence[float],
                               spacing: Sequence[float], alpha: float,
                               beta: float, gamma: float):
    """Best vesselness over scales and the winning scale's eigenvector frame
    ``q`` (``(3, 3, *shape)``, value-ascending columns; reference
    UpdateVesselness)."""
    best_resp = best_q = None
    for sigma in scales:
        h = hessian(u, sigma, spacing, normalize_across_scale=True)
        w, q = eigh3(h)
        resp = vesselness_measure(sort_by_abs3(w), alpha, beta, gamma)
        if best_resp is None:
            best_resp, best_q = resp, q
        else:
            better = resp > best_resp
            best_resp = torch.where(better, resp, best_resp)
            best_q = torch.where(better, q, best_q)
    return best_resp, best_q


def generate_diffusion_tensor(response: torch.Tensor, q: torch.Tensor,
                              epsilon: float, omega: float,
                              sensitivity: float) -> torch.Tensor:
    """``T = Q D Q^T``, D = diag(1+(eps-1)V, 1+(eps-1)V, 1+(omega-1)V), the
    identity where V <= 0 (reference GenerateDiffusionTensor, .hxx:302-378);
    ``q[i, j]`` are eigenvector component planes; returns ``(6, *shape)``."""
    v = torch.pow(torch.clamp(response, min=0.0), 1.0 / sensitivity)
    d1 = 1.0 + (epsilon - 1.0) * v
    d3 = 1.0 + (omega - 1.0) * v
    d = (d1, d1, d3)
    active = v > 0
    planes = []
    for i, j in sym_pairs(3):
        t_ij = sum(q[i, k] * d[k] * q[j, k] for k in range(3))
        planes.append(torch.where(active, t_ij, 1.0 if i == j else 0.0))
    return torch.stack(planes)


@functools.lru_cache(maxsize=32)
def _make_assemble_fn(epsilon: float, omega: float, sensitivity: float):
    """The B9 formula, rank-1 form: ``Q diag(d1, d1, d3) Q^T = d1 I +
    (d3 - d1) q3 q3^T`` (the reference weights the two smaller eigen-
    directions alike, .hxx:327-356), so only the largest eigenvalue's
    eigenvector is needed.  Equal to :func:`generate_diffusion_tensor` up to
    rounding, and up to the arbitrary choice within a degenerate top
    eigenspace."""

    def assemble(resp: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        _, q3 = eigh3(h, vectors_mode="largest")
        v = torch.pow(torch.clamp(resp, min=0.0), 1.0 / sensitivity)
        d1 = 1.0 + (epsilon - 1.0) * v
        diff = (omega - epsilon) * v  # d3 - d1
        active = v > 0
        planes = []
        for i, j in sym_pairs(3):
            t_ij = diff * q3[i] * q3[j]
            if i == j:
                t_ij = t_ij + d1
            planes.append(torch.where(active, t_ij, 1.0 if i == j else 0.0))
        return torch.stack(planes)

    return assemble


def _fused_scales_kernel(u, scales, spacing, alpha, beta, gamma, epsilon,
                         omega, sensitivity, z_valid_radius):
    """The kernel path of :func:`_fused_scales` (smooth_fd): per scale B6 ->
    B7 -> B8 (the running best updated in place), then B9 once."""
    best = None
    for sigma in scales:
        us = smoothed_field_valid_z(u, sigma, spacing, z_valid_radius,
                                    use_kernels=True)
        best = cuda_vesselness.fd_vesselness(
            us, fd_factors(sigma, spacing, True), (alpha, beta, gamma), best,
            measure_fn=vesselness_measure,
        )
    resp, h = best
    t = cuda_vesselness.tensor_assembly(
        resp, h, epsilon, omega, sensitivity,
        assemble_fn=_make_assemble_fn(epsilon, omega, sensitivity),
    )
    return resp, t


def _fused_scales_gd_kernel(u, scales, spacing, alpha, beta, gamma, epsilon,
                            omega, sensitivity, z_valid_radius):
    """The kernel path of :func:`_fused_scales` (gaussian_derivative): per
    scale the B6/B10 Hessian, then B15 on it (the first scale's stack becomes
    the running best, updated in place after), then B9 once."""
    best = None
    for sigma in scales:
        h = hessian(u, sigma, spacing, normalize_across_scale=True,
                    z_valid_radius=z_valid_radius, mode="gaussian_derivative",
                    use_kernels=True)
        best = cuda_vesselness.hessian_vesselness(h, (alpha, beta, gamma), best,
                                                  measure_fn=vesselness_measure)
    resp, h = best
    t = cuda_vesselness.tensor_assembly(
        resp, h, epsilon, omega, sensitivity,
        assemble_fn=_make_assemble_fn(epsilon, omega, sensitivity),
    )
    return resp, t


def _fused_scales(u, scales, spacing, alpha, beta, gamma, epsilon, omega,
                  sensitivity, z_valid_radius, hessian_mode="gaussian_derivative",
                  use_kernels: bool = False):
    """Best response and tensor over scales: the response needs eigenvalues
    only, the scale loop carries the running-best Hessian, and one final
    eigendecomposition of the winning Hessian gives the tensor."""
    if hessian_mode == "smooth_fd" and use_kernels and u.dim() == 3:
        return _fused_scales_kernel(u, scales, spacing, alpha, beta, gamma,
                                    epsilon, omega, sensitivity, z_valid_radius)
    if hessian_mode == "gaussian_derivative" and use_kernels and u.dim() == 3:
        return _fused_scales_gd_kernel(u, scales, spacing, alpha, beta, gamma,
                                       epsilon, omega, sensitivity, z_valid_radius)
    math_dtype = compute_dtype(u.dtype)
    best_resp = best_h = None
    for sigma in scales:
        h = hessian(u, sigma, spacing, normalize_across_scale=True,
                    z_valid_radius=z_valid_radius, mode=hessian_mode,
                    use_kernels=use_kernels)
        w, _ = eigh3(h.to(math_dtype), compute_vectors=False)
        resp = vesselness_measure(sort_by_abs3(w), alpha, beta, gamma)
        if best_resp is None:
            # the first scale always initializes the running maximum (.hxx:272)
            best_resp, best_h = resp, h
        else:
            better = resp > best_resp
            best_resp = torch.where(better, resp, best_resp)
            best_h = torch.where(better, h, best_h)
    _, q = eigh3(best_h.to(math_dtype))
    return best_resp, generate_diffusion_tensor(best_resp, q, epsilon, omega,
                                                sensitivity)


def fused_vesselness_tensor(u, scales, spacing, alpha, beta, gamma, epsilon,
                            omega, sensitivity, z_slab: int | None = None,
                            hessian_mode: str = "gaussian_derivative",
                            pipeline_dtype=None, use_kernels: bool = False):
    """Vesselness response ``(Z, Y, X)`` and diffusion tensor
    ``(6, Z, Y, X)``, both in the math dtype.

    ``z_slab``: process the volume in slabs of that thickness along z, each
    with a shared max-radius z halo (edge-replicated at the domain borders)
    and valid-mode z convolutions, so the result equals the untiled one and
    the temporaries are O(slab)."""
    if pipeline_dtype is not None:
        u = u.to(torch_dtype(pipeline_dtype))
    if z_slab is None or z_slab >= u.shape[0]:
        return _fused_scales(u, scales, spacing, alpha, beta, gamma, epsilon,
                             omega, sensitivity, None, hessian_mode, use_kernels)
    nz = u.shape[0]
    if nz % z_slab != 0:
        raise ValueError(f"z_slab {z_slab} must divide the z extent {nz}")
    radius = max(kernel_radius(float(s), float(spacing[0])) for s in scales)
    if hessian_mode == "smooth_fd":
        radius += 1  # the finite-difference shell
    u_pad = edge_pad(u, radius)
    math_dtype = compute_dtype(u.dtype)
    resp = torch.empty(u.shape, dtype=math_dtype, device=u.device)
    tensor = torch.empty((6, *u.shape), dtype=math_dtype, device=u.device)
    for z0 in range(0, nz, z_slab):
        slab = u_pad[z0:z0 + z_slab + 2 * radius]
        r, t = _fused_scales(slab, scales, spacing, alpha, beta, gamma,
                             epsilon, omega, sensitivity, radius, hessian_mode,
                             use_kernels)
        resp[z0:z0 + z_slab] = r
        tensor[:, z0:z0 + z_slab] = t
        del r, t
    return resp, tensor


class VEDResult(NamedTuple):
    output: torch.Tensor
    #: vesselness response of the last outer iteration.
    vesselness: torch.Tensor
    #: diffusion tensor of the last outer iteration, ``(6, Z, Y, X)``.
    tensor: torch.Tensor
    #: MADResult of the last diffusion solve.
    diffusion: MADResult


#: volumes above this many voxels get a z-slab-tiled pipeline by default
_AUTO_TILE_VOXELS = 32 * 1024 * 1024


def _auto_z_slab(shape: Tuple[int, ...], requested: int | None) -> int | None:
    """Resolve VEDConfig.pipeline_z_slab: 0 = auto, None = never, int = that."""
    if requested is None:
        return None
    if requested:
        return requested
    nz = shape[0]
    if int(np.prod(shape)) <= _AUTO_TILE_VOXELS:
        return None
    target = max(16, nz // 8)
    divisors = [d for d in range(1, nz + 1) if nz % d == 0 and d <= target]
    return divisors[-1] if divisors else None


def ved(image, spacing: Sequence[float] | None = None,
        config: VEDConfig | None = None, dtype=None, mesh=None,
        device=None, min_local: int = 8) -> VEDResult:
    """Run the full VED filter on a 3D volume (numpy or torch).

    ``device``: ``None`` means the CUDA card and raises when there is none;
    ``device="cpu"`` asks for the CPU.  ``dtype``: the solve precision,
    float64 on the CPU and float32 on CUDA by default.  ``mesh``: a
    :class:`~..parallel.sharding.GridMesh`; every rank passes the whole
    volume and gets back its blocks (output, vesselness, tensor)."""
    with span(VED):
        config = config or VEDConfig()
        if image.ndim != 3:
            raise ValueError(f"VED expects a 3D volume, got rank {image.ndim}")
        if mesh is not None:
            from ..parallel.sharding import require_mesh

            require_mesh(mesh)
            device = mesh.device if device is None else device
        device = resolve_device(device)
        if dtype is None:
            dtype = torch.float64 if device.type == "cpu" else torch.float32
        dtype = torch_dtype(dtype)
        if spacing is None:
            spacing = (1.0,) * 3
        spacing = tuple(float(h) for h in spacing)
        if isinstance(image, torch.Tensor):
            u = image.to(device=device, dtype=dtype)
        else:
            u = torch.as_tensor(np.asarray(image), dtype=dtype, device=device)
        u = u.contiguous()
        mad_cfg = config.mad_config()
        args = (tuple(config.scales), spacing, config.alpha, config.beta, config.gamma,
                config.epsilon, config.omega, config.sensitivity)
        if mesh is None:
            pipeline = functools.partial(
                fused_vesselness_tensor,
                z_slab=_auto_z_slab(tuple(u.shape), config.pipeline_z_slab),
                hessian_mode=config.hessian_mode, pipeline_dtype=config.pipeline_dtype,
                use_kernels=config.use_kernels)
        else:
            pipeline = _mesh_pipeline(tuple(u.shape), mesh, config, args)

        resp = tensor = diffusion = None
        for it in range(config.iterations):
            if it and mesh is not None:
                from ..parallel.sharding import gather_field

                u = gather_field(u, mesh)
            # with a mesh the outputs are whole on every rank: the solve's setup
            # runs replicated, from the whole tensor
            with span(VED_PIPELINE):
                resp, tensor = pipeline(u, *args)
            diffusion = mad_diffusion(u, tensor, spacing=spacing, config=mad_cfg,
                                      dtype=dtype, device=device, mesh=mesh,
                                      min_local=min_local)
            u = diffusion.output
        if mesh is not None:
            from ..parallel.sharding import output_block

            shape, whole = tuple(resp.shape), (None,) * 3
            resp = output_block(resp, mesh, shape, whole, shape)
            tensor = output_block(tensor, mesh, shape, whole, shape)
        return VEDResult(output=u, vesselness=resp, tensor=tensor, diffusion=diffusion)


def _mesh_pipeline(shape, mesh, config: VEDConfig, args):
    """The distributed pipeline (``u`` whole on every rank -> the whole
    response and tensor on every rank): z slabs where the shape splits into
    them, else the single-device pipeline on the whole volume on every rank,
    as the JAX package's global-view path computes it."""
    from ..parallel.pipeline import make_sharded_vesselness_pipeline

    slab = (shape[0] // mesh.size,) + tuple(shape[1:])
    sharded = make_sharded_vesselness_pipeline(
        shape, mesh, *args, hessian_mode=config.hessian_mode,
        pipeline_dtype=config.pipeline_dtype, use_kernels=config.use_kernels,
        z_slab=_auto_z_slab(slab, config.pipeline_z_slab))
    if sharded is not None:
        return lambda u, *_: sharded(u)
    logging.getLogger(__name__).info(
        "VED on mesh %s: the z extent of %s does not split into %d slabs of at least "
        "the pipeline halo; every rank runs the whole-volume pipeline",
        mesh.shape, shape, mesh.size)
    return functools.partial(
        fused_vesselness_tensor, z_slab=config.pipeline_z_slab or None,
        hessian_mode=config.hessian_mode, pipeline_dtype=config.pipeline_dtype,
        use_kernels=config.use_kernels)
