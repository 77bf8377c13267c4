"""Verbose solve path: the reference's per-level residual trace.

Counterpart of ``multigridanisotropicdiffusion_tpu.models.trace``.  The
reference's ``m_Verbose`` flag prints the relative residual after every
smoother iteration at every level, indented by depth
(itkMultigridAnisotropicDiffusionImageFilter.hxx:363-369, 393-399, 441-448,
469-475).  The production solver (:mod:`.mad`) records one residual per outer
cycle; this module re-runs the same cycle eagerly and reports everything the
reference reports, with the same text.  Each reported residual is a
device-to-host read, so the trace is for debugging, convergence studies and
golden comparisons, not for throughput.

It builds the hierarchy and uses the smoother, residual and transfers of
``config`` (``use_kernels`` included), so on the card it traces the kernels
the solve runs; like the JAX package's trace it runs every cycle in the
solve dtype (no defect cycles) and leaves the Galerkin levels unpruned.
With a mesh it traces the distributed solve: the same halo-exchange
smoothers, block transfers and global norms as ``mad_diffusion``; volumes
that need pad-to-divisible embeddings are refused, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.grids import build_level_descriptors
from ..core.stencil import l2_norm
from ..core.symfield import as_sym_planes
from ..utils.benchlog import ResidualTraceLogger
from .mad import (
    FMG,
    SMOOTHER,
    MADConfig,
    _at,
    _check_mesh_config,
    _level_layouts,
    _mesh_ops,
    _single_device_ops,
    build_hierarchy,
    full_multigrid,
    resolve_device,
    torch_dtype,
)


def mad_diffusion_verbose(
    image,
    tensor,
    spacing: Sequence[float] | None = None,
    config: MADConfig | None = None,
    dtype=None,
    print_fn: Callable[[str], None] = print,
    logger: ResidualTraceLogger | None = None,
    mesh=None,
    device=None,
    min_local: int = 8,
):
    """Eager MAD solve with the reference's verbose per-level residual trace.

    Returns ``(output, trace)``, ``trace`` the list of emitted lines.
    ``device`` and ``dtype`` as in :func:`.mad.mad_diffusion` (the card
    unless ``device="cpu"``).  ``mesh``: trace the distributed solve
    (every rank passes the whole input, emits the same lines and returns
    its block of the output).
    """
    config = config or MADConfig()
    if mesh is not None:
        from ..parallel.sharding import require_mesh

        require_mesh(mesh)
        _check_mesh_config(config, min_local)
        device = mesh.device if device is None else device
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    dtype = torch_dtype(dtype)

    shape = tuple(image.shape)
    planes = as_sym_planes(tensor, shape, dtype=dtype, device=device)
    levels = build_level_descriptors(shape, spacing)
    coarsest = len(levels) - 1
    hier = build_hierarchy(planes, levels, config.time_step, config.coarse_operator,
                           config.operator_repr, config.use_kernels,
                           config.galerkin_variant)
    del planes
    if isinstance(image, torch.Tensor):
        b = image.to(device=device, dtype=dtype)
    else:
        b = torch.as_tensor(np.asarray(image), dtype=dtype, device=device)
    b = b.contiguous()

    if mesh is None:
        smooth, resid, transfers, _ = _single_device_ops(levels, config)

        def norm(x, level):
            return l2_norm(x)
    else:
        from ..parallel.sharding import global_sum, shard_field, shard_hierarchy

        layouts = _level_layouts(mesh, levels, min_local)
        if any(lay.pshape != lay.shape for lay in layouts):
            raise ValueError("mad_diffusion_verbose does not take volumes that need "
                             f"pad-to-divisible embeddings (shape {shape} on mesh "
                             f"{mesh.shape}); use a mesh-divisible shape")
        hier = shard_hierarchy(hier, mesh, min_local)
        b = shard_field(b, mesh, spec=layouts[0].spec)
        smooth, resid, transfers, _ = _mesh_ops(mesh, levels, layouts, config)

        def norm(x, level):
            return torch.sqrt(global_sum(torch.sum(x * x), mesh, layouts[level].spec))

    lines = []

    def emit(depth: int, text: str) -> None:
        line = " " * depth + text
        lines.append(line)
        print_fn(line)

    def rel(op, x, b, bnorm, level):
        return float(norm(_at(resid, level)(op, x, b), level) / bnorm)

    def smooth_and_report(op, x, b, level, bnorm):
        for n in range(config.iterations_per_grid):
            x = _at(smooth, level)(op, x, b)
            r = rel(op, x, b, bnorm, level)
            emit(level + 1, f"Level {level}, iteration {n + 1}: relative residual = {r}")
            if level == 0 and logger is not None:
                logger.log(r)
        return x

    def v_cycle(x, b, level):
        bnorm = float(norm(b, level))
        op = hier.operators[level]
        if level == coarsest:
            x = transfers.solve_coarse(hier.solver, b, level)
            emit(level + 1, f"Level {level}, direct solver: relative residual = "
                            f"{rel(op, x, b, bnorm, level)}")
            return x
        x = smooth_and_report(op, x, b, level, bnorm)
        rc = transfers.restrict(_at(resid, level)(op, x, b), level)
        ec = v_cycle(torch.zeros_like(rc), rc, level + 1)
        x = transfers.prolong_add(x, ec, level)
        r = rel(op, x, b, bnorm, level)
        emit(level + 1, f"Level {level}, initial relative residual = {r}")
        if level == 0 and logger is not None:
            logger.log(r)
        return smooth_and_report(op, x, b, level, bnorm)

    op0 = hier.operators[0]
    for step in range(config.number_of_steps):
        if logger is not None:
            logger.restart()
        if config.number_of_steps > 1:
            emit(0, f"------------ Time step n. {step + 1} / {config.number_of_steps} "
                    "------------")
        rhs_norm = float(norm(b, 0))
        if config.cycle == FMG:
            emit(0, "|--- Full Multigrid Cycle ---|")
            x = full_multigrid(hier, levels, smooth, config.iterations_per_grid, b,
                               0, resid, transfers=transfers)
        else:
            x = b
        k = 0
        while True:
            if config.cycle == SMOOTHER:
                x = _at(smooth, 0)(op0, x, b)
                r = rel(op0, x, b, rhs_norm, 0)
                emit(0, f"Smoother iteration n. {k + 1}: relative residual = {r}")
                if logger is not None:
                    logger.log(r)
            else:
                emit(0, f"|--- VCycle n. {k + 1} ---|")
                x = v_cycle(x, b, 0)
                r = rel(op0, x, b, rhs_norm, 0)
            k += 1
            if r <= config.tolerance or k >= config.max_cycles:
                break
        b = x

    if mesh is not None:
        from ..parallel.sharding import output_block

        b = output_block(b, mesh, shape, layouts[0].spec, shape)
    return b, lines
