"""``kernels.galerkin_roofline``: the least time of the traced calls'
Galerkin products (``bench_port/workcount_galerkin.py``: per level, the fine
operator's planes read once and the coarse planes written once, at the
setup's precision, over the card's bandwidth; one hierarchy a call) over the
device time of B16's launches in those calls
(``workcount_galerkin.is_product_kernel``), in %.  Counted for Galerkin
levels built through the kernels on cell-centred 3D hierarchies; nothing to
read elsewhere."""

import math

from bench_port import portspans, workcount, workcount_galerkin
from bench_port.devtrace import union


def read(ctx):
    cfg = ctx.mad_config
    shape = tuple(ctx.cell.traffic["shape"])
    if (ctx.window is None or not cfg.use_kernels or cfg.coarse_operator != "galerkin"
            or len(shape) != 3):
        return None
    try:
        least = workcount_galerkin.setup_seconds(shape, cfg.galerkin_variant,
                                                 workcount.BYTES[ctx.cell.config["dtype"]])
    except ValueError:  # a vertex-centred level: not counted
        return None
    prof = portspans._caller_profiler()
    if prof is None:
        return None
    spans = union((e["ts"], e["ts"] + e["dur"]) for e in portspans.trace_events(prof)
                  if e["cat"] == "kernel" and workcount_galerkin.is_product_kernel(e["name"]))
    device = sum(b - a for a, b in spans) / 1e6
    least *= len(ctx.calls)
    return 100.0 * least / device if device > 0 and math.isfinite(least) else None
