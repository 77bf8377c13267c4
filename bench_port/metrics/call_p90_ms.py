"""``call_p90_ms``: the 90th percentile of the window's call times, in ms."""

import statistics


def read(ctx):
    if len(ctx.times) < 2:
        return None
    return 1e3 * statistics.quantiles(ctx.times, n=10, method="inclusive")[-1]
