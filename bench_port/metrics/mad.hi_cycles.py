"""``mad.hi_cycles``: cycles per implicit step that ran in the solve's own
precision, the port's ``madt.mad.cycle.hi`` spans over its ``madt.mad.step``
spans in the traced window (0.0 where every cycle ran in the defect dtype).
Nothing to read where the port has no such spans."""

from bench_port import portspans


def read(ctx):
    step, hi = portspans.port_span("MAD_STEP"), portspans.port_span("MAD_CYCLE_HI")
    calls = portspans.per_call(ctx) if step and hi else None
    steps = sum(c[step].count for c in calls or () if step in c)
    if not steps:
        return None
    return sum(c[hi].count for c in calls if hi in c) / steps
