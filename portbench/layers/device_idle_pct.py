"""``device_idle_pct``: the share of the profiled span's wall time in
which the device ran nothing."""


def read(ctx):
    if ctx.span is None or ctx.span.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.span.busy_s / ctx.span.wall_s)
