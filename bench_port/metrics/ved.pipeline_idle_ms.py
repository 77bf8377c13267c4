"""``ved.pipeline_idle_ms``: milliseconds per call in which the card is idle
while the host is inside the port's ``madt.ved.pipeline`` span (the
vesselness pipeline).  Nothing to read where no call ran the pipeline, or
the port has no such span."""

from bench_port import portspans


def read(ctx):
    return portspans.mean_ms(ctx, "VED_PIPELINE", "idle_s")
