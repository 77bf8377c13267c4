"""``setup_s``: process start to the first measured call, in s."""


def read(ctx):
    return ctx.setup_s
