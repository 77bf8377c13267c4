"""``device.idle_pct``: share of the traced window in which no operation ran
on the card: 1 - (union of the operations' intervals) / window, in %."""


def read(ctx):
    if ctx.window is None or ctx.window.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.window.busy_s / ctx.window.window_s)
