"""``h2d_wait_ms.dmr``: host milliseconds a block queuing the block's copy
to the card (a pinned block is copied on a side stream; pageable input
takes a blocking copy): the DMR pipeline's span ``dmr.h2d``, over the
profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("dmr.h2d", blocks="dmr.blocks")
