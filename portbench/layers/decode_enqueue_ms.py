"""``decode_enqueue_ms``: host milliseconds a block from the pick's end
to the voice decode's launches and the carries' hand-over (padding, the
index copies, IMBE ECC, K2, synthesis, K3): the program's span
``p25.decode_enqueue``, over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("p25.decode_enqueue", blocks="p25.blocks")
