"""``device_busy_ms``: the union of the device's activity (kernels and
copies) a block over the profiled span of whole blocks."""


def read(ctx):
    if ctx.span is None or ctx.span.busy_s <= 0:
        return None
    return 1e3 * ctx.span.busy_s / ctx.span.n_blocks
