"""``pcm_wait_ms``: host milliseconds a block waiting for the voice
decode and copying its wire to the host: the program's span
``p25.pcm_d2h`` (``fetch_pcm``), over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("p25.pcm_d2h", blocks="p25.blocks")
