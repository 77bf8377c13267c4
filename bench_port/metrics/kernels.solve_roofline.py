"""``kernels.solve_roofline``: the least time of the solves' algorithmic work
(``bench_port/workcount.py``: level visits of the V-cycle, each operand read
once, at the precision each cycle ran in) over the device time of the
operations launched inside ``mad_diffusion`` but outside its setup, in %.
Counted for the 3D compressed operator of the defect correction, the path
the port's ``cuda()`` configurations take; nothing to read elsewhere."""

import math

from bench_port import workcount


def read(ctx):
    cfg = ctx.mad_config
    shape = tuple(ctx.cell.traffic["shape"])
    if (ctx.window is None or cfg.defect_dtype is None or cfg.operator_repr != "compressed"
            or len(shape) != 3 or cfg.cycle != "vcycle"):
        return None
    solve_bytes = workcount.BYTES[ctx.cell.config["dtype"]]
    defect_bytes = workcount.BYTES[str(cfg.defect_dtype)]
    least = 0.0
    for call in ctx.calls:
        for cycles, hist in zip(call["num_cycles"], call["histories"]):
            per_cycle = workcount.cycle_bytes(hist, cycles, cfg.tolerance,
                                              cfg.defect_switch_factor, solve_bytes,
                                              defect_bytes)
            least += workcount.step_seconds(shape, cfg.iterations_per_grid,
                                            workcount.PLANES_3D, per_cycle, solve_bytes)
    device = sum(d.get("bench.solve", 0.0) for d in ctx.window.device_s)
    return 100.0 * least / device if device > 0 and math.isfinite(least) else None
