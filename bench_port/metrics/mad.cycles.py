"""``mad.cycles``: V-cycles per implicit step, the mean over the traced calls'
steps (``MADResult.num_cycles``; for VED, its last solve's)."""


def read(ctx):
    counts = [k for call in ctx.calls for k in call["num_cycles"]]
    return sum(counts) / len(counts) if counts else None
