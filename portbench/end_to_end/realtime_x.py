"""``realtime_x``: the RF seconds of all channels of every block whose
output reached the host inside the window, over the wall seconds from
the window's start to the last such completion."""

from portbench import stats


def read(ctx):
    return stats.realtime_x(ctx.channels, ctx.block_s,
                            len(ctx.window.latencies), ctx.window.span_s)
