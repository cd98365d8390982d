"""``candidates_wait_ms``: host milliseconds a block in
``frontend_finish``, waiting for the front end and copying its
candidates to the host: the program's span ``p25.candidates_d2h``, over
the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("p25.candidates_d2h", blocks="p25.blocks")
