"""``pick_ms``: host milliseconds a block in the LDU pick (``pick_ldus``:
the peak walk, the NID lookup, the card's NID decode of uncovered hits,
LDU acceptance): the program's span ``p25.pick``, over the profiled
span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("p25.pick", blocks="p25.blocks")
