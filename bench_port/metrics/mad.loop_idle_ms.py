"""``mad.loop_idle_ms``: milliseconds per call in which the card is idle
while the host is inside one of the port's ``madt.mad.step`` spans (the
implicit steps: the cast, the cycles, the residuals and the host read of
each).  Nothing to read where the port has no such span."""

from bench_port import portspans


def read(ctx):
    return portspans.mean_ms(ctx, "MAD_STEP", "idle_s")
