"""``peak_gib``: the card's peak of allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), less the
harness's own resident inputs (the tube field), in GiB.  Each call's inputs,
which a user hands to the call, count."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
