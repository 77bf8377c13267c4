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
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.grids import build_level_descriptors
from ..core.stencil import l2_norm
from ..core.symfield import as_sym_planes
from ..ops.coarse import coarse_solve
from ..ops.smoothers import make_residual, make_smoother
from ..ops.transfer import prolong, restrict
from ..utils.benchlog import ResidualTraceLogger
from .mad import FMG, SMOOTHER, MADConfig, build_hierarchy, full_multigrid, resolve_device, torch_dtype


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
):
    """Eager MAD solve with the reference's verbose per-level residual trace.

    Returns ``(output, trace)``, ``trace`` the list of emitted lines.
    ``device`` and ``dtype`` as in :func:`.mad.mad_diffusion` (the card
    unless ``device="cpu"``).  ``mesh``: distribution is not ported yet
    (ROADMAP A11).
    """
    if mesh is not None:
        raise NotImplementedError(
            "the distributed verbose trace (mesh) is not ported yet (ROADMAP A11)"
        )
    config = config or MADConfig()
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
    smooth = make_smoother(config.smoother, config.jacobi_weight,
                           use_kernels=config.use_kernels)
    resid = make_residual(use_kernels=config.use_kernels)
    use_kernels = config.use_kernels

    lines = []

    def emit(depth: int, text: str) -> None:
        line = " " * depth + text
        lines.append(line)
        print_fn(line)

    def rel(op, x, b, bnorm):
        return float(l2_norm(resid(op, x, b)) / bnorm)

    def smooth_and_report(op, x, b, level, bnorm):
        for n in range(config.iterations_per_grid):
            x = smooth(op, x, b)
            r = rel(op, x, b, bnorm)
            emit(level + 1, f"Level {level}, iteration {n + 1}: relative residual = {r}")
            if level == 0 and logger is not None:
                logger.log(r)
        return x

    def v_cycle(x, b, level):
        bnorm = float(l2_norm(b))
        op = hier.operators[level]
        if level == coarsest:
            x = coarse_solve(hier.solver, b)
            emit(level + 1, f"Level {level}, direct solver: relative residual = "
                            f"{rel(op, x, b, bnorm)}")
            return x
        x = smooth_and_report(op, x, b, level, bnorm)
        cent = levels[level + 1].centering
        rc = restrict(resid(op, x, b), cent, use_kernels)
        ec = v_cycle(torch.zeros_like(rc), rc, level + 1)
        x = x + prolong(ec, cent, use_kernels)
        r = rel(op, x, b, bnorm)
        emit(level + 1, f"Level {level}, initial relative residual = {r}")
        if level == 0 and logger is not None:
            logger.log(r)
        return smooth_and_report(op, x, b, level, bnorm)

    if isinstance(image, torch.Tensor):
        b = image.to(device=device, dtype=dtype)
    else:
        b = torch.as_tensor(np.asarray(image), dtype=dtype, device=device)
    b = b.contiguous()
    op0 = hier.operators[0]
    for step in range(config.number_of_steps):
        if logger is not None:
            logger.restart()
        if config.number_of_steps > 1:
            emit(0, f"------------ Time step n. {step + 1} / {config.number_of_steps} "
                    "------------")
        rhs_norm = float(l2_norm(b))
        if config.cycle == FMG:
            emit(0, "|--- Full Multigrid Cycle ---|")
            x = full_multigrid(hier, levels, smooth, config.iterations_per_grid, b,
                               0, resid, use_kernels)
        else:
            x = b
        k = 0
        while True:
            if config.cycle == SMOOTHER:
                x = smooth(op0, x, b)
                r = rel(op0, x, b, rhs_norm)
                emit(0, f"Smoother iteration n. {k + 1}: relative residual = {r}")
                if logger is not None:
                    logger.log(r)
            else:
                emit(0, f"|--- VCycle n. {k + 1} ---|")
                x = v_cycle(x, b, 0)
                r = rel(op0, x, b, rhs_norm)
            k += 1
            if r <= config.tolerance or k >= config.max_cycles:
                break
        b = x

    return b, lines
