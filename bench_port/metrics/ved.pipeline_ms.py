"""``ved.pipeline_ms``: device milliseconds per call of the operations that
the VED pipeline (``models.ved.fused_vesselness_tensor``: B6-B11 and the
eager eigensolves) launched, the union of their intervals.  Nothing to read
where no call ran the pipeline."""


def read(ctx):
    if ctx.window is None:
        return None
    per_call = [d["bench.pipeline"] for d in ctx.window.device_s if "bench.pipeline" in d]
    return 1e3 * sum(per_call) / len(per_call) if per_call else None
