"""``handoff_wait_pct.dmr``: of the results the DMR pipeline handed from
the card to the host (the candidates and the PCM, ``dmr.handoffs``),
the share the host waited for (``dmr.handoff_waited``), the counters
over the profiled span.  Near 100: the card sets the pace; near 0: the
host does.  A diagnostic, not a direction to optimise."""

from portbench import spans


def read(ctx):
    return spans.pct("dmr.handoff_waited", "dmr.handoffs",
                     blocks="dmr.blocks")
