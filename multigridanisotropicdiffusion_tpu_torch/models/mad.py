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
* Distribution (``mesh=``, :mod:`..parallel`): every rank of a
  :class:`~..parallel.sharding.GridMesh` receives the whole input, builds
  the whole hierarchy (the setup runs replicated, as in the JAX package),
  keeps its blocks, and solves on them with explicit halo exchanges
  (``halo='shard_map'``: exchange, then contract; ``'overlap'``: contract
  against zero halos while the faces move, then splice the boundary slabs;
  the same bits either way; XLA's ``'gspmd'`` has no counterpart), block
  transfers between levels, a replicated coarsest solve and global norms
  that every rank computes alike.  With ``use_kernels`` the 3D radius-1
  levels run the shard-local kernel B14, overlapped with the exchange in
  both modes.  Each rank returns
  its block of the output (:func:`..parallel.sharding.output_range`);
  :func:`..parallel.sharding.gather_field` assembles the whole volume.
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
from ..ops.transfer import prolong, prolong_add, restrict, restrict_tensor
from ..utils.profiling import (MAD, MAD_ASSEMBLE, MAD_CAST, MAD_COARSE, MAD_CYCLE_HI,
                               MAD_CYCLE_LO, MAD_RESIDUAL, MAD_RESTRICT, MAD_SETUP,
                               MAD_STEP, MAD_SYNC, span)

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
    #: distribution strategy with a mesh (ignored without), the JAX
    #: package's names: 'shard_map' exchanges the halos, then contracts;
    #: 'overlap' contracts against zero halos while the faces move (a side
    #: CUDA stream) and then recomputes the boundary slabs; the two give the
    #: same bits (parallel.halo).  The kernel path (use_kernels) is
    #: overlapped in both.  Both need a stored or compressed operator and a
    #: GS/Jacobi/Chebyshev smoother.
    halo: str = "overlap"
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
        if self.halo == "gspmd":
            raise ValueError("halo='gspmd' (XLA's partitioner) has no counterpart in "
                             "PyTorch: use halo='overlap', the same math")
        if self.halo not in ("shard_map", "overlap"):
            raise ValueError(f"unknown halo mode: {self.halo!r}")
        if self.defect_dtype is not None:
            torch_dtype(self.defect_dtype)  # must name a dtype

    @classmethod
    def cuda(cls, mixed_precision: bool = True, **kw) -> "MADConfig":
        """The H100 fast path: compressed operator + the CUDA kernels (+ bf16
        inner defect cycles unless ``mixed_precision=False``); the
        counterpart of the JAX package's ``MADConfig.tpu()``; with a mesh the
        sweeps run B14 per block (``halo='overlap'``, as ``tpu()``).  Keyword
        overrides pass through to the constructor."""
        kw.setdefault("operator_repr", "compressed")
        kw.setdefault("use_kernels", True)
        kw.setdefault("halo", "overlap")
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

    with span(MAD_ASSEMBLE):
        ops = [make_op(tensor, levels[0])]
    t = tensor
    if coarse_operator == GALERKIN:
        # the literal R A P of A = I - dt*L loses diagonal dominance down
        # deep chains; the identity stays exact on every level
        # (ops.galerkin.assemble_galerkin_parabolic)
        collapse = galerkin_variant == "collapsed"
        for lvl in levels[1:]:
            with span(MAD_ASSEMBLE):
                ops.append(assemble_galerkin_parabolic(ops[-1], lvl.centering,
                                                       collapse=collapse))
    elif coarse_operator == DCA:
        for lvl in levels[1:]:
            with span(MAD_RESTRICT):
                t = restrict_tensor(t, lvl.centering, use_kernels)
            with span(MAD_ASSEMBLE):
                ops.append(make_op(t, lvl))
    else:
        raise ValueError(f"unknown coarse operator: {coarse_operator!r}")
    with span(MAD_COARSE):
        if isinstance(ops[-1], StencilOperator):
            coarsest_stored = ops[-1]
        else:
            coarsest_stored = assemble_dca(t, levels[-1].spacing, time_step)
        solver = build_coarse_solver(coarsest_stored)
    return Hierarchy(operators=tuple(ops), solver=solver)


class Transfers(NamedTuple):
    """The level hooks of the cycles: ``restrict(r, fine_level)``,
    ``prolong(e, fine_level)``, ``solve_coarse(solver, b, level)`` and
    ``prolong_add(x, e, fine_level)``, the V-cycle's correction ``x +
    prolong(e, fine_level)`` into a new tensor (one kernel pass on the
    kernel path).  The standard ones apply ops.transfer / ops.coarse to
    whole fields; the distributed solve's act on blocks
    (:mod:`..parallel.transfer`)."""

    restrict: object
    prolong: object
    solve_coarse: object
    prolong_add: object


def _standard_transfers(levels: Tuple[GridLevel, ...], use_kernels: bool = False) -> Transfers:
    return Transfers(
        restrict=lambda r, fl: restrict(r, levels[fl + 1].centering, use_kernels),
        prolong=lambda e, fl: prolong(e, levels[fl + 1].centering, use_kernels),
        solve_coarse=lambda solver, b, level: coarse_solve(solver, b),
        prolong_add=lambda x, e, fl: prolong_add(x, e, levels[fl + 1].centering,
                                                 use_kernels),
    )


def _at(fn, level: int):
    """A smoother or residual for ``level``: one function for every level,
    or one per level (the distributed solve's, whose blocks carry their
    level's split)."""
    return fn[level] if isinstance(fn, (tuple, list)) else fn


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
    transfers: Transfers | None = None,
) -> torch.Tensor:
    """One V-cycle starting at ``level`` (reference VCycle, .hxx:341-493).
    At the coarsest level the initial guess is ignored and the rhs is solved
    directly.  ``use_kernels`` routes the standard transfers through their
    kernels; ``transfers`` replaces them."""
    if transfers is None:
        transfers = _standard_transfers(levels, use_kernels)
    if level == len(levels) - 1:
        return transfers.solve_coarse(hier.solver, b, level)

    op = hier.operators[level]
    sm = _at(smooth, level)
    for _ in range(iterations_per_grid):
        x = sm(op, x, b)
    r = _at(resid, level)(op, x, b)

    rc = transfers.restrict(r, level)
    ec = v_cycle(hier, levels, smooth, iterations_per_grid, torch.zeros_like(rc),
                 rc, level + 1, resid, use_kernels, transfers)
    x = transfers.prolong_add(x, ec, level)

    for _ in range(iterations_per_grid):
        x = sm(op, x, b)
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
    transfers: Transfers | None = None,
) -> torch.Tensor:
    """Full multigrid initialization (reference FullMultiGrid, .hxx:300-338)."""
    if transfers is None:
        transfers = _standard_transfers(levels, use_kernels)
    if level == len(levels) - 1:
        x = torch.zeros_like(b)
        for _ in range(iterations_per_grid):
            x = v_cycle(hier, levels, smooth, iterations_per_grid, x, b, level,
                        resid, use_kernels, transfers)
        return x

    bc = transfers.restrict(b, level)
    xc = full_multigrid(hier, levels, smooth, iterations_per_grid, bc, level + 1,
                        resid, use_kernels, transfers)
    x = transfers.prolong(xc, level)
    for _ in range(iterations_per_grid):
        x = v_cycle(hier, levels, smooth, iterations_per_grid, x, b, level,
                    resid, use_kernels, transfers)
    return x


class _SolveOps(NamedTuple):
    """What a time step needs besides the hierarchy: the smoother and the
    residual (one, or one per level), the transfers and the L2 norm."""

    smooth: object
    resid: object
    transfers: Transfers
    norm: object


def _single_device_ops(levels, config: MADConfig) -> _SolveOps:
    return _SolveOps(
        smooth=make_smoother(config.smoother, config.jacobi_weight,
                             use_kernels=config.use_kernels),
        resid=make_residual(use_kernels=config.use_kernels),
        transfers=_standard_transfers(levels, config.use_kernels),
        norm=l2_norm,
    )


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
                     config: MADConfig, b: torch.Tensor, ops: _SolveOps | None = None):
    """One implicit time step: cycles until the relative L2 residual falls
    below tolerance or max_cycles is hit (do-while, .hxx:207-246).  Returns
    ``(x, cycles, final relres tensor, history tensor)``."""
    if ops is None:
        ops = _single_device_ops(levels, config)
    if config.defect_dtype is not None:
        return _solve_time_step_defect(hier, levels, config, b, ops)
    smooth, resid, transfers, norm = ops
    op0 = hier.operators[0]
    dtype = b.dtype
    tol = _in_dtype(config.tolerance, dtype)
    rhs_norm = norm(b)

    if config.cycle == FMG:
        x = full_multigrid(hier, levels, smooth, config.iterations_per_grid, b,
                           0, resid, transfers=transfers)
    else:
        x = b  # previous step's solution as the initial guess (.hxx:180-201)

    hist = torch.zeros((config.max_cycles,), dtype=dtype, device=b.device)
    relres = torch.tensor(math.inf, dtype=dtype, device=b.device)
    k = 0
    relres_host = math.inf
    while k < config.max_cycles and relres_host > tol:
        with span(MAD_CYCLE_HI):
            if config.cycle == SMOOTHER:
                x = _at(smooth, 0)(op0, x, b)
            else:
                x = v_cycle(hier, levels, smooth, config.iterations_per_grid, x, b,
                            0, resid, transfers=transfers)
        with span(MAD_RESIDUAL):
            relres = norm(_at(resid, 0)(op0, x, b)) / rhs_norm
            hist[k] = relres
        with span(MAD_SYNC):
            relres_host = float(relres)
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
    ops: _SolveOps,
):
    """Mixed-precision defect correction: ``x += cycle_lo(0, b - A x)``.

    The outer residual uses the exact full-precision operator, so the inner
    precision (``config.defect_dtype``) bounds only the per-cycle
    contraction, not the attainable residual.
    """
    smooth, resid, transfers, norm = ops
    lo = torch_dtype(config.defect_dtype)
    dtype = b.dtype
    op0 = hier.operators[0]
    with span(MAD_CAST):
        hier_lo = _cast_operators(hier, lo)
    tol = _in_dtype(config.tolerance, dtype)
    switch = float(config.defect_switch_factor)
    hi_top = _in_dtype(config.tolerance * switch, dtype)
    hi_bottom = _in_dtype(config.tolerance * (switch / 20.0), dtype)
    rhs_norm = norm(b)
    resid0 = _at(resid, 0)

    def inner(h, r):
        if config.cycle == SMOOTHER:
            return _at(smooth, 0)(h.operators[0], torch.zeros_like(r), r)
        return v_cycle(h, levels, smooth, config.iterations_per_grid,
                       torch.zeros_like(r), r, 0, resid, transfers=transfers)

    if config.cycle == FMG:
        x = full_multigrid(hier_lo, levels, smooth, config.iterations_per_grid,
                           b.to(lo), 0, resid, transfers=transfers).to(dtype)
    else:
        x = b  # previous step's solution as the initial guess (.hxx:180-201)

    hist = torch.zeros((config.max_cycles,), dtype=dtype, device=b.device)
    relres = torch.tensor(math.inf, dtype=dtype, device=b.device)
    r = resid0(op0, x, b)
    k = 0
    relres_host = math.inf
    while k < config.max_cycles and relres_host > tol:
        # precision schedule: a full-precision cycle where it can finish the
        # solve and a low-precision one cannot (the window below); cheap
        # low-precision cycles everywhere else
        if switch > 0.0 and hi_bottom < relres_host <= hi_top:
            with span(MAD_CYCLE_HI):
                d = inner(hier, r)
        else:
            with span(MAD_CYCLE_LO):
                d = inner(hier_lo, r.to(lo)).to(dtype)
        with span(MAD_RESIDUAL):
            x = x + d
            r = resid0(op0, x, b)
            relres = norm(r) / rhs_norm
            hist[k] = relres
        with span(MAD_SYNC):
            relres_host = float(relres)
        k += 1
    return x, k, relres, hist


def _solve_all_steps(hier, levels, config, b, ops: _SolveOps | None = None) -> MADResult:
    hists, counts, finals = [], [], []
    for _ in range(config.number_of_steps):
        with span(MAD_STEP):
            b, k, relres, hist = _solve_time_step(hier, levels, config, b, ops)
        hists.append(hist)
        counts.append(k)
        finals.append(relres)
    return MADResult(
        output=b,
        residual_history=torch.stack(hists),
        num_cycles=torch.tensor(counts, dtype=torch.int32),
        final_residual=torch.stack(finals),
    )


# ---------------------------------------------------------------------------
# the distributed solve
# ---------------------------------------------------------------------------


def _level_layouts(mesh, levels: Tuple[GridLevel, ...], min_local: int):
    """Per level: true shape, padded embedding (parallel.padding) and split;
    the counterpart of the JAX package's ``_padded_shapes``."""
    from ..parallel.padding import padded_level_shape
    from ..parallel.sharding import level_spec
    from ..parallel.transfer import Layout

    out = []
    for lvl in levels:
        pshape = padded_level_shape(mesh, lvl.shape, min_local)
        out.append(Layout(lvl.shape, pshape, level_spec(mesh, pshape, min_local)))
    return tuple(out)


def _make_halo_ops(mesh, layouts, config: MADConfig):
    """Per-level halo-exchange smoothers and residuals on the blocks
    (parallel.halo), overlapped when ``config.halo == 'overlap'``: with
    ``use_kernels`` the 3D radius-1 levels run B14 (the compressed operator
    and stored radius-1 levels; always overlapped), the others the plain
    halo path, as the JAX package runs XLA for them."""
    from ..parallel import halo as H

    if config.operator_repr == "matrix_free":
        raise ValueError("a mesh needs operator_repr='stored' or 'compressed' (the "
                         "matrix-free operator has no planes to exchange halos for)")
    overlap = config.halo == "overlap"
    smooths, resids = [], []
    for lay in layouts:
        spec = lay.spec
        if config.smoother in ("gauss_seidel", "gs", "rbgs"):
            sm = (H.make_halo_kernel_rbgs_sweep(mesh, spec) if config.use_kernels
                  else H.make_halo_rbgs_sweep(mesh, spec, overlap))
        elif config.smoother in ("weighted_jacobi", "wj", "jacobi"):
            sm = H.make_halo_jacobi_sweep(mesh, spec, config.jacobi_weight, overlap)
        elif config.smoother in ("chebyshev", "cheby"):
            sm = H.make_halo_chebyshev_smoother(mesh, spec, overlap=overlap)
        else:
            raise ValueError("a mesh supports the gauss_seidel, weighted_jacobi and "
                             f"chebyshev smoothers (got {config.smoother!r})")
        smooths.append(sm)
        resids.append(H.make_halo_kernel_residual(mesh, spec) if config.use_kernels
                      else H.make_halo_residual(mesh, spec, overlap))
    return tuple(smooths), tuple(resids)


def _mesh_ops(mesh, levels, layouts, config: MADConfig) -> _SolveOps:
    from ..parallel.sharding import global_sum
    from ..parallel.transfer import BlockTransfers

    smooth, resid = _make_halo_ops(mesh, layouts, config)
    spec0 = layouts[0].spec

    def norm(x):
        return torch.sqrt(global_sum(torch.sum(x * x), mesh, spec0))

    return _SolveOps(smooth, resid, BlockTransfers(mesh, levels, layouts, config.use_kernels),
                     norm)


def _check_mesh_config(config: MADConfig, min_local: int) -> None:
    if (config.coarse_operator == GALERKIN and config.galerkin_variant == "exact"
            and min_local < 2):
        # exact Galerkin levels reach radius 2: a one-hop exchange needs
        # blocks at least that thick
        raise ValueError("a mesh with exact Galerkin coarse operators needs min_local >= 2 "
                         f"(got {min_local}); raise min_local or use "
                         "galerkin_variant='collapsed'")


def mad_diffusion(
    image,
    tensor,
    spacing: Sequence[float] | None = None,
    config: MADConfig | None = None,
    dtype=None,
    hierarchy: Hierarchy | None = None,
    device=None,
    mesh=None,
    min_local: int = 8,
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
        and time step), of the whole domain.
      device: where to solve; ``None`` means the CUDA card, and raises
        when there is none.  ``device="cpu"`` asks for the CPU (the plain
        PyTorch versions of the kernels).  With a mesh: the mesh's device.
      mesh: a :class:`~..parallel.sharding.GridMesh`; every rank passes
        the whole ``image`` and ``tensor`` and gets back its block of the
        output (``result.output``; the histories are global).  Levels whose
        blocks would drop below ``min_local`` points per axis are
        replicated (agglomeration).
    """
    with span(MAD):
        config = config or MADConfig()
        if mesh is not None:
            from ..parallel.sharding import require_mesh

            require_mesh(mesh)
            _check_mesh_config(config, min_local)
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
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
            with span(MAD_SETUP):
                planes = as_sym_planes(tensor, shape, dtype=dtype, device=device)
                hierarchy = build_hierarchy(planes, levels, config.time_step,
                                            config.coarse_operator, config.operator_repr,
                                            config.use_kernels, config.galerkin_variant)
                del planes
                if (config.coarse_operator == GALERKIN and config.galerkin_variant == "exact"
                        and config.galerkin_prune_tol > 0):
                    # after the coarse LU, as in the JAX package: the coarsest
                    # level's solver keeps the unpruned operator
                    ops = (hierarchy.operators[0],) + tuple(
                        prune_stored_operator(op, config.galerkin_prune_tol)
                        for op in hierarchy.operators[1:])
                    hierarchy = Hierarchy(operators=ops, solver=hierarchy.solver)

        if mesh is None:
            result = _solve_all_steps(hierarchy, levels, config, b)
        else:
            from ..parallel.padding import pad_field, pad_hierarchy
            from ..parallel.sharding import output_block, shard_field, shard_hierarchy

            layouts = _level_layouts(mesh, levels, min_local)
            pshapes = tuple(lay.pshape for lay in layouts)
            # pad-to-divisible embeddings, then this rank's blocks
            hierarchy = shard_hierarchy(pad_hierarchy(hierarchy, pshapes), mesh, min_local)
            b = shard_field(pad_field(b, pshapes[0]), mesh, spec=layouts[0].spec)
            result = _solve_all_steps(hierarchy, levels, config, b,
                                      _mesh_ops(mesh, levels, layouts, config))
            result = result._replace(output=output_block(
                result.output, mesh, shape, layouts[0].spec, pshapes[0]))
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
