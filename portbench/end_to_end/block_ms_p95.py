"""``block_ms_p95``: the 95th percentile, over every block completed in
the window, of its time from hand-off to the port to its output on the
host."""

from portbench import stats


def read(ctx):
    return stats.p95_ms(ctx.window.latencies)
