"""``galerkin.setup_ms``: device milliseconds per call under the port's
``madt.mad.setup.galerkin`` spans, the Galerkin levels' products
``I - R (I - A_f) P`` and their collapse in the solver's setup (the union of
the operations' intervals).  Nothing to read where the port has no such
span."""

from bench_port import portspans


def read(ctx):
    return portspans.mean_ms(ctx, "MAD_GALERKIN", "device_s")
