"""``frontend_enqueue_ms.dmr``: host milliseconds a block launching the
DMR front end after the copy (K1, the symbolizer, the sync filter and
sort, the EMB gate) and queuing the candidates' copy to the host: the
span ``dmr.frontend_enqueue``, over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("dmr.frontend_enqueue", blocks="dmr.blocks")
