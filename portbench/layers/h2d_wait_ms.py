"""``h2d_wait_ms``: host milliseconds a block blocked on the block's copy
to the card, and on whatever was queued on the card before it: the
program's spans ``p25.h2d`` (``frontend_dispatch``'s copy) and
``band.h2d`` (``engine.wideband._complex_on``), over the profiled
span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("p25.h2d", "band.h2d", blocks="p25.blocks")
