"""``kernels.exact_stored_roofline``: ``kernels.stored_roofline`` on the
exact Galerkin levels: the least time of the solves' stencil work on the
stored levels ``1 .. L-2``, each at its own plane count (117 on level 1, 125
below; ``bench_port/workcount_galerkin.py``), over the device time of B12's
launches in the traced calls (``workcount_stored.is_stored_kernel``), in %.
Counted for unpruned exact Galerkin levels, cell-centred, under the defect
correction's V-cycle with the kernels; nothing to read elsewhere."""

import math

from bench_port import portspans, workcount, workcount_galerkin, workcount_stored
from bench_port.devtrace import union


def read(ctx):
    cfg = ctx.mad_config
    shape = tuple(ctx.cell.traffic["shape"])
    if (ctx.window is None or cfg.defect_dtype is None or not cfg.use_kernels
            or cfg.coarse_operator != "galerkin" or cfg.galerkin_variant != "exact"
            or cfg.galerkin_prune_tol > 0 or len(shape) != 3 or cfg.cycle != "vcycle"):
        return None
    try:
        workcount_galerkin.level_planes(shape, workcount_galerkin.EXACT)
    except ValueError:  # a vertex-centred level: not counted
        return None
    prof = portspans._caller_profiler()
    if prof is None:
        return None
    spans = union((e["ts"], e["ts"] + e["dur"]) for e in portspans.trace_events(prof)
                  if e["cat"] == "kernel" and workcount_stored.is_stored_kernel(e["name"]))
    device = sum(b - a for a, b in spans) / 1e6
    solve_bytes = workcount.BYTES[ctx.cell.config["dtype"]]
    defect_bytes = workcount.BYTES[str(cfg.defect_dtype)]
    least = 0.0
    for call in ctx.calls:
        for cycles, hist in zip(call["num_cycles"], call["histories"]):
            per_cycle = workcount.cycle_bytes(hist, cycles, cfg.tolerance,
                                              cfg.defect_switch_factor, solve_bytes,
                                              defect_bytes)
            least += workcount_galerkin.exact_step_seconds(shape, cfg.iterations_per_grid,
                                                           per_cycle)
    return 100.0 * least / device if device > 0 and math.isfinite(least) else None
