"""``mad.setup_ms``: host milliseconds per call inside the solver's setup
(``models.mad.build_hierarchy``: assembly B5, tensor restriction B3, the
coarse LU), which the traced run synchronises on entry and exit."""


def read(ctx):
    if ctx.window is None:
        return None
    per_call = [w["bench.setup"] for w in ctx.window.wall_s]
    return 1e3 * sum(per_call) / len(per_call) if per_call else None
