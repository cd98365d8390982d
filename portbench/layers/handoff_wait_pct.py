"""``handoff_wait_pct``: of the results the P25 pipeline handed from the
card to the host (the candidates and the PCM, counter ``p25.handoffs``),
the share the host waited for (``p25.handoff_waited``: an event not yet
complete when the host reached it, or a blocking copy), the program's
counters over the profiled span.  Near 100: the host waits on the card,
so the card sets the pace; near 0: the host sets it.  A diagnostic, not
a direction to optimise."""

from portbench import spans


def read(ctx):
    return spans.pct("p25.handoff_waited", "p25.handoffs", blocks="p25.blocks")
