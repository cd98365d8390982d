"""``block_ms_p95_host``: the window's ``block_ms_p95`` (hand-off to
output on the host, p95 over every block completed in the window), read
in the traced run where the host's noise is too wide for an end-to-end
bound (the pipelined P25 loop)."""

from portbench import stats


def read(ctx):
    return stats.p95_ms(ctx.window.latencies) if ctx.window.latencies \
        else None
