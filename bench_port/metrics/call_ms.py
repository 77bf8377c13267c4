"""``call_ms``: all the window's calls' time over their number (each call
from the entry to the synchronisation after it), in ms."""

import statistics


def read(ctx):
    return 1e3 * statistics.fmean(ctx.times) if ctx.times else None
