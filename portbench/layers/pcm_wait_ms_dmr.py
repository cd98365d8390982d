"""``pcm_wait_ms.dmr``: host milliseconds a block waiting for the queued
copy of the DMR voice decode's wire: the span ``dmr.pcm_d2h``
(``fetch_pcm``), over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("dmr.pcm_d2h", blocks="dmr.blocks")
