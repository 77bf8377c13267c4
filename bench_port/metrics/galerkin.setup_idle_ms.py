"""``galerkin.setup_idle_ms``: milliseconds per call in which the card is
idle while the host is inside one of the port's ``madt.mad.setup.galerkin``
spans: how far the eager Galerkin products wait on the host.  Nothing to read
where the port has no such span."""

from bench_port import portspans


def read(ctx):
    return portspans.mean_ms(ctx, "MAD_GALERKIN", "idle_s")
