"""``pcm_expand_ms.dmr``: host milliseconds a block expanding the DMR
wire to float32 PCM (the C++ ADPCM expand, both slots' PCM): the span
``dmr.pcm_expand`` (``fetch_pcm``), over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("dmr.pcm_expand", blocks="dmr.blocks")
