"""Multigrid anisotropic-diffusion solver (the MAD filter).

Counterpart of ``multigridanisotropicdiffusion_tpu.models.mad``: implicit
Euler time stepping for ``∂t u = div(M ∇u)``, each step solving
``A u^{n+1} = u^n`` with ``A = Id - dt*L`` by geometric multigrid
(reference ``itk::MultigridAnisotropicDiffusionImageFilter``).

Differences from the JAX package:

* PyTorch runs eagerly, so the level recursion is plain Python and the outer
  tolerance loop is a host loop with one device-to-host sync per cycle (on
  the relative residual).  The precision window of the defect cycles is a
  Python ``if`` on that same host value.
* ``MADConfig.use_kernels`` routes the solve through the CUDA kernels: the
  stencil half-sweeps and residuals of every operator the JAX package sends
  to Pallas (``ops.smoothers.has_kernel``: the compressed operator in 2D and
  3D, ``ops.cuda_smoothers``/``ops.cuda_stencil2d``; 3D stored operators of
  radius 1-2, ``ops.cuda_stencil_stored``; 2D stored radius 1), the 3D
  restriction and prolongation (``ops.cuda_transfer``) and the 3D
  compressed-operator assembly (``ops.cuda_assemble``).  It stands for the
  JAX package's ``use_pallas`` flag *and* its ``default_backend() == "tpu"``
  gates on assembly and transfers.  On a CPU tensor each kernel wrapper
  takes its plain version; on a CUDA tensor it launches the kernel or
  raises.
* The matrix-free operator (``operator_repr='matrix_free'``,
  :mod:`..ops.matfree`) and the Chebyshev smoother have no kernels, in the
  JAX package or here: they run as plain PyTorch on every device.  The JAX
  package's deprecated ``MADConfig.matrix_free`` alias is not carried over.
* Not ported yet, and refused with ``NotImplementedError``: device meshes
  and halo exchange (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.grids import GridLevel, build_level_descriptors
from ..core.stencil import StencilOperator, l2_norm, residual
from ..core.symfield import as_sym_planes
from ..ops.coarse import CoarseSolver, build_coarse_solver, coarse_solve
from ..ops.compressed import assemble_compressed_dca
from ..ops.dca import assemble_dca
from ..ops.galerkin import assemble_galerkin_parabolic, prune_stored_operator
from ..ops.matfree import MatrixFreeDCAOperator
from ..ops.smoothers import DEFAULT_JACOBI_WEIGHT, make_residual, make_smoother
from ..ops.transfer import prolong, restrict, restrict_tensor

VCYCLE = "vcycle"
FMG = "fmg"
SMOOTHER = "smoother"

DCA = "dca"
GALERKIN = "galerkin"


def torch_dtype(name) -> torch.dtype:
    """A torch dtype from a dtype or its name ('bfloat16', 'float32', ...)."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a dtype name: {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class MADConfig:
    """Solver parameters, mirroring the reference's setters and defaults."""

    time_step: float = 0.01
    number_of_steps: int = 1
    cycle: str = VCYCLE
    iterations_per_grid: int = 2
    tolerance: float = 1e-6
    max_cycles: int = 100
    smoother: str = "gauss_seidel"
    jacobi_weight: float = DEFAULT_JACOBI_WEIGHT
    #: 'dca' (re-discretize every level) or 'galerkin' (A_c = I - R (I -
    #: A_f) P from the finer level, ops.galerkin).
    coarse_operator: str = DCA
    #: Galerkin levels (coarse_operator='galerkin' only): 'collapsed' lumps
    #: each level's coarsened dt*L onto radius 1 with exact row sums (27
    #: planes in 3D), 'exact' keeps the full product (radius 2 under cell
    #: centring, up to 117/125 planes).
    galerkin_variant: str = "collapsed"
    #: exact-Galerkin plane pruning: coarse-level planes below this
    #: fraction of the diagonal's maximum are lumped onto their clipped
    #: radius-1 offset (ops.galerkin.prune_stored_operator); 0 keeps all.
    galerkin_prune_tol: float = 0.0
    #: 'stored' (19/9 planes), 'compressed' (10/6 planes, ops.compressed)
    #: or 'matrix_free' (applied from the tensor planes, ops.matfree).
    operator_repr: str = "stored"
    #: run the 3D solve through the CUDA kernels (see the module docstring):
    #: the counterpart of the JAX package's use_pallas plus its TPU-backend
    #: gates on assembly and transfers.
    use_kernels: bool = False
    #: print the per-cycle relative-residual trace after the solve.
    verbose: bool = False
    #: mixed-precision defect correction: each outer cycle computes the
    #: residual in the solve dtype against the exact operator and runs the
    #: inner cycle on the defect in this dtype (e.g. 'bfloat16') with a
    #: low-precision copy of the hierarchy.
    defect_dtype: str | None = None
    #: precision schedule of the defect cycles: an inner cycle runs in full
    #: precision when the relative residual lies in
    #: (tolerance * factor / 20, tolerance * factor]; 0 disables the switch.
    defect_switch_factor: float = 2000.0

    def __post_init__(self):
        if self.cycle not in (VCYCLE, FMG, SMOOTHER):
            raise ValueError(f"unknown cycle type: {self.cycle!r}")
        if self.coarse_operator not in (DCA, GALERKIN):
            raise ValueError(f"unknown coarse operator: {self.coarse_operator!r}")
        if self.galerkin_variant not in ("exact", "collapsed"):
            raise ValueError(f"unknown galerkin_variant: {self.galerkin_variant!r}")
        if self.operator_repr not in ("stored", "compressed", "matrix_free"):
            raise ValueError(f"unknown operator_repr: {self.operator_repr!r}")
        if self.defect_dtype is not None:
            torch_dtype(self.defect_dtype)  # must name a dtype

    @classmethod
    def cuda(cls, mixed_precision: bool = True, **kw) -> "MADConfig":
        """The H100 fast path: compressed operator + the CUDA kernels (+ bf16
        inner defect cycles unless ``mixed_precision=False``); the
        counterpart of the JAX package's ``MADConfig.tpu()`` without a mesh.
        Keyword overrides pass through to the constructor."""
        kw.setdefault("operator_repr", "compressed")
        kw.setdefault("use_kernels", True)
        if mixed_precision:
            kw.setdefault("defect_dtype", "bfloat16")
        return cls(**kw)


class Hierarchy(NamedTuple):
    """Multigrid setup products: one operator per level plus the coarsest
    level's direct solver."""

    operators: Tuple[object, ...]
    solver: CoarseSolver


def build_hierarchy(
    tensor: torch.Tensor,
    levels: Tuple[GridLevel, ...],
    time_step: float,
    coarse_operator: str = DCA,
    operator_repr: str = "stored",
    use_kernels: bool = False,
    galerkin_variant: str = "collapsed",
) -> Hierarchy:
    """Assemble the per-level operators (the setup phase, once per tensor).

    DCA re-discretizes each level from the level-wise restricted tensor
    (itkGridsHierarchy.hxx:110-201); Galerkin computes every coarser level
    from the one above it as ``I - R (I - A_f) P`` (stored operators,
    ``galerkin_variant`` as in :class:`MADConfig`).  ``operator_repr`` picks
    the stored, compressed or matrix-free form of level 0 and of the DCA
    levels; the coarsest level's stored form feeds the dense LU.  With
    ``use_kernels``, 3D compressed assembly and the 3D tensor restriction go
    through their kernels.
    """
    if operator_repr == "compressed":
        def make_op(t, lvl):
            if use_kernels and len(lvl.shape) == 3:
                from ..ops.cuda_assemble import cuda_assemble_compressed_dca

                return cuda_assemble_compressed_dca(t, lvl.spacing, time_step)
            return assemble_compressed_dca(t, lvl.spacing, time_step)
    elif operator_repr == "stored":
        def make_op(t, lvl):
            return assemble_dca(t, lvl.spacing, time_step)
    elif operator_repr == "matrix_free":
        def make_op(t, lvl):
            return MatrixFreeDCAOperator(t, lvl.spacing, time_step)
    else:
        raise ValueError(f"unknown operator_repr: {operator_repr!r}")

    ops = [make_op(tensor, levels[0])]
    t = tensor
    if coarse_operator == GALERKIN:
        # the literal R A P of A = I - dt*L loses diagonal dominance down
        # deep chains; the identity stays exact on every level
        # (ops.galerkin.assemble_galerkin_parabolic)
        collapse = galerkin_variant == "collapsed"
        for lvl in levels[1:]:
            ops.append(assemble_galerkin_parabolic(ops[-1], lvl.centering,
                                                   collapse=collapse))
    elif coarse_operator == DCA:
        for lvl in levels[1:]:
            t = restrict_tensor(t, lvl.centering, use_kernels)
            ops.append(make_op(t, lvl))
    else:
        raise ValueError(f"unknown coarse operator: {coarse_operator!r}")
    if isinstance(ops[-1], StencilOperator):
        coarsest_stored = ops[-1]
    else:
        coarsest_stored = assemble_dca(t, levels[-1].spacing, time_step)
    return Hierarchy(operators=tuple(ops), solver=build_coarse_solver(coarsest_stored))


def v_cycle(
    hier: Hierarchy,
    levels: Tuple[GridLevel, ...],
    smooth,
    iterations_per_grid: int,
    x: torch.Tensor,
    b: torch.Tensor,
    level: int = 0,
    resid=residual,
    use_kernels: bool = False,
) -> torch.Tensor:
    """One V-cycle starting at ``level`` (reference VCycle, .hxx:341-493).
    At the coarsest level the initial guess is ignored and the rhs is solved
    directly.  ``use_kernels`` routes the transfers through their kernels."""
    if level == len(levels) - 1:
        return coarse_solve(hier.solver, b)

    op = hier.operators[level]
    cent = levels[level + 1].centering
    for _ in range(iterations_per_grid):
        x = smooth(op, x, b)
    r = resid(op, x, b)

    rc = restrict(r, cent, use_kernels)
    ec = v_cycle(hier, levels, smooth, iterations_per_grid, torch.zeros_like(rc),
                 rc, level + 1, resid, use_kernels)
    x = x + prolong(ec, cent, use_kernels)

    for _ in range(iterations_per_grid):
        x = smooth(op, x, b)
    return x


def full_multigrid(
    hier: Hierarchy,
    levels: Tuple[GridLevel, ...],
    smooth,
    iterations_per_grid: int,
    b: torch.Tensor,
    level: int = 0,
    resid=residual,
    use_kernels: bool = False,
) -> torch.Tensor:
    """Full multigrid initialization (reference FullMultiGrid, .hxx:300-338)."""
    if level == len(levels) - 1:
        x = torch.zeros_like(b)
        for _ in range(iterations_per_grid):
            x = v_cycle(hier, levels, smooth, iterations_per_grid, x, b, level,
                        resid, use_kernels)
        return x

    cent = levels[level + 1].centering
    bc = restrict(b, cent, use_kernels)
    xc = full_multigrid(hier, levels, smooth, iterations_per_grid, bc, level + 1,
                        resid, use_kernels)
    x = prolong(xc, cent, use_kernels)
    for _ in range(iterations_per_grid):
        x = v_cycle(hier, levels, smooth, iterations_per_grid, x, b, level,
                    resid, use_kernels)
    return x


class MADResult(NamedTuple):
    output: torch.Tensor
    #: (number_of_steps, max_cycles) relative residual after each cycle
    #: (entries past the last cycle are 0).
    residual_history: torch.Tensor
    #: (number_of_steps,) cycles used per time step.
    num_cycles: torch.Tensor
    #: (number_of_steps,) final relative residual per time step.
    final_residual: torch.Tensor


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another (``device="cpu"``).  Never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port's entry points run on "
                "the card by default; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the JAX package's comparisons of a
    ``dtype`` residual with a Python float see it."""
    return torch.tensor(value, dtype=dtype).item()


def _solve_time_step(hier: Hierarchy, levels: Tuple[GridLevel, ...],
                     config: MADConfig, b: torch.Tensor):
    """One implicit time step: cycles until the relative L2 residual falls
    below tolerance or max_cycles is hit (do-while, .hxx:207-246).  Returns
    ``(x, cycles, final relres tensor, history tensor)``."""
    smooth = make_smoother(config.smoother, config.jacobi_weight,
                           use_kernels=config.use_kernels)
    resid = make_residual(use_kernels=config.use_kernels)
    if config.defect_dtype is not None:
        return _solve_time_step_defect(hier, levels, config, b, smooth, resid)
    op0 = hier.operators[0]
    dtype = b.dtype
    tol = _in_dtype(config.tolerance, dtype)
    rhs_norm = l2_norm(b)

    if config.cycle == FMG:
        x = full_multigrid(hier, levels, smooth, config.iterations_per_grid, b,
                           0, resid, config.use_kernels)
    else:
        x = b  # previous step's solution as the initial guess (.hxx:180-201)

    hist = torch.zeros((config.max_cycles,), dtype=dtype, device=b.device)
    relres = torch.tensor(math.inf, dtype=dtype, device=b.device)
    k = 0
    while k < config.max_cycles and float(relres) > tol:
        if config.cycle == SMOOTHER:
            x = smooth(op0, x, b)
        else:
            x = v_cycle(hier, levels, smooth, config.iterations_per_grid, x, b,
                        0, resid, config.use_kernels)
        relres = l2_norm(resid(op0, x, b)) / rhs_norm
        hist[k] = relres
        k += 1
    return x, k, relres, hist


def _cast_operators(hier: Hierarchy, dtype: torch.dtype) -> Hierarchy:
    """Low-precision copy of the per-level operators (the coarsest LU stays
    in the factorization precision; coarse_solve casts at its boundary)."""
    return Hierarchy(operators=tuple(op.astype(dtype) for op in hier.operators),
                     solver=hier.solver)


def _solve_time_step_defect(
    hier: Hierarchy,
    levels: Tuple[GridLevel, ...],
    config: MADConfig,
    b: torch.Tensor,
    smooth,
    resid,
):
    """Mixed-precision defect correction: ``x += cycle_lo(0, b - A x)``.

    The outer residual uses the exact full-precision operator, so the inner
    precision (``config.defect_dtype``) bounds only the per-cycle
    contraction, not the attainable residual.
    """
    lo = torch_dtype(config.defect_dtype)
    dtype = b.dtype
    op0 = hier.operators[0]
    hier_lo = _cast_operators(hier, lo)
    tol = _in_dtype(config.tolerance, dtype)
    switch = float(config.defect_switch_factor)
    hi_top = _in_dtype(config.tolerance * switch, dtype)
    hi_bottom = _in_dtype(config.tolerance * (switch / 20.0), dtype)
    rhs_norm = l2_norm(b)

    def inner(h, r):
        if config.cycle == SMOOTHER:
            return smooth(h.operators[0], torch.zeros_like(r), r)
        return v_cycle(h, levels, smooth, config.iterations_per_grid,
                       torch.zeros_like(r), r, 0, resid, config.use_kernels)

    if config.cycle == FMG:
        x = full_multigrid(hier_lo, levels, smooth, config.iterations_per_grid,
                           b.to(lo), 0, resid, config.use_kernels).to(dtype)
    else:
        x = b  # previous step's solution as the initial guess (.hxx:180-201)

    hist = torch.zeros((config.max_cycles,), dtype=dtype, device=b.device)
    relres = torch.tensor(math.inf, dtype=dtype, device=b.device)
    r = resid(op0, x, b)
    k = 0
    relres_host = math.inf
    while k < config.max_cycles and relres_host > tol:
        # precision schedule: a full-precision cycle where it can finish the
        # solve and a low-precision one cannot (the window below); cheap
        # low-precision cycles everywhere else
        if switch > 0.0 and hi_bottom < relres_host <= hi_top:
            d = inner(hier, r)
        else:
            d = inner(hier_lo, r.to(lo)).to(dtype)
        x = x + d
        r = resid(op0, x, b)
        relres = l2_norm(r) / rhs_norm
        hist[k] = relres
        relres_host = float(relres)
        k += 1
    return x, k, relres, hist


def _solve_all_steps(hier, levels, config, b) -> MADResult:
    hists, counts, finals = [], [], []
    for _ in range(config.number_of_steps):
        b, k, relres, hist = _solve_time_step(hier, levels, config, b)
        hists.append(hist)
        counts.append(k)
        finals.append(relres)
    return MADResult(
        output=b,
        residual_history=torch.stack(hists),
        num_cycles=torch.tensor(counts, dtype=torch.int32),
        final_residual=torch.stack(finals),
    )


def mad_diffusion(
    image,
    tensor,
    spacing: Sequence[float] | None = None,
    config: MADConfig | None = None,
    dtype=None,
    hierarchy: Hierarchy | None = None,
    device=None,
    mesh=None,
) -> MADResult:
    """Run the MAD filter: setup + ``number_of_steps`` implicit steps.

    Args:
      image: input field ``(*grid_shape)`` (2D or 3D), numpy or torch.
      tensor: symmetric diffusion tensor field: a ``(D(D+1)/2, *shape)``
        stack or tuple of planes (core.symfield order), or a matrix field in
        ``(D, D, *shape)`` / ``(*shape, D, D)`` layout (lower triangle read).
      spacing: physical voxel spacing (defaults to 1.0 per dim).
      config: solver parameters (defaults mirror the reference).
      dtype: solve precision; defaults to float64 on the CPU (the
        reference's double precision) and float32 on CUDA.
      hierarchy: reuse a prebuilt :class:`Hierarchy` (same tensor, spacing
        and time step).
      device: where to solve; ``None`` means the CUDA card, and raises
        when there is none.  ``device="cpu"`` asks for the CPU (the plain
        PyTorch versions of the kernels).
      mesh: distribution over devices is not ported yet (ROADMAP A11).
    """
    config = config or MADConfig()
    if mesh is not None:
        raise NotImplementedError(
            "distributed solves (mesh/halo) are not ported yet (ROADMAP A11)"
        )
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    dtype = torch_dtype(dtype)

    shape = tuple(image.shape)
    levels = build_level_descriptors(shape, spacing)
    if isinstance(image, torch.Tensor):
        b = image.to(device=device, dtype=dtype)
    else:
        b = torch.as_tensor(np.asarray(image), dtype=dtype, device=device)
    b = b.contiguous()

    if hierarchy is None:
        planes = as_sym_planes(tensor, shape, dtype=dtype, device=device)
        hierarchy = build_hierarchy(planes, levels, config.time_step,
                                    config.coarse_operator, config.operator_repr,
                                    config.use_kernels, config.galerkin_variant)
        if (config.coarse_operator == GALERKIN and config.galerkin_variant == "exact"
                and config.galerkin_prune_tol > 0):
            # after the coarse LU, as in the JAX package: the coarsest
            # level's solver keeps the unpruned operator
            ops = (hierarchy.operators[0],) + tuple(
                prune_stored_operator(op, config.galerkin_prune_tol)
                for op in hierarchy.operators[1:])
            hierarchy = Hierarchy(operators=ops, solver=hierarchy.solver)

    result = _solve_all_steps(hierarchy, levels, config, b)
    if config.verbose:
        print_residual_trace(result, config)
    return result


def print_residual_trace(result: MADResult, config: MADConfig,
                         print_fn=print) -> None:
    """Host-side per-cycle residual trace (the ``verbose`` output): one line
    per outer cycle per time step from ``MADResult.residual_history``."""
    label = {VCYCLE: "VCycle", FMG: "VCycle", SMOOTHER: "Smoother iteration"}[
        config.cycle
    ]
    hist = result.residual_history.cpu().numpy()
    counts = result.num_cycles.cpu().numpy()
    for step in range(hist.shape[0]):
        if hist.shape[0] > 1:
            print_fn(
                f"------------ Time step n. {step + 1} / {hist.shape[0]} "
                "------------"
            )
        for k in range(int(counts[step])):
            print_fn(f"{label} n. {k + 1}: relative residual = {hist[step, k]}")
