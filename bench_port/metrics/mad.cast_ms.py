"""``mad.cast_ms``: device milliseconds per call under the port's
``madt.mad.cast`` span, the low-precision copy of the hierarchy that each
implicit step of the defect correction makes (the union of the operations'
intervals).  Nothing to read where the port has no such span."""

from bench_port import portspans


def read(ctx):
    return portspans.mean_ms(ctx, "MAD_CAST", "device_s")
