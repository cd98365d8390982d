"""``frontend_enqueue_ms``: host milliseconds a block launching the
front end after the copy (K1, the symbolizer, the sync filter and sort,
the NID decode): the program's span ``p25.frontend_enqueue``, over the
profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("p25.frontend_enqueue", blocks="p25.blocks")
