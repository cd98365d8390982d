"""``decode_enqueue_ms.dmr``: host milliseconds a block from the pick's
end to the launches of the DMR voice decode (the staged index copy, the
superframe gather, AMBE+2 ECC, dequantization, frame repeat, synthesis,
K3) and the wire's queued copy: the span ``dmr.decode_enqueue``, over
the profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("dmr.decode_enqueue", blocks="dmr.blocks")
