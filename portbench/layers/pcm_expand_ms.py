"""``pcm_expand_ms``: host milliseconds a block in the wire's expansion
to float32 PCM (the C++ ADPCM expand): the program's span
``p25.pcm_expand`` (``fetch_pcm``), over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("p25.pcm_expand", blocks="p25.blocks")
