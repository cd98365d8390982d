"""``candidates_wait_ms.dmr``: host milliseconds a block in
``frontend_finish``, waiting for the queued copy of the DMR front end's
candidates: the span ``dmr.candidates_d2h``, over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("dmr.candidates_d2h", blocks="dmr.blocks")
