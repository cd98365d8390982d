"""``pick_ms.dmr``: host milliseconds a block in the superframe pick
(``pick_superframes``: the per-channel walk over the candidates, the
score and EMB gate, the shoulder): the span ``dmr.pick``, over the
profiled span."""

from portbench import spans


def read(ctx):
    return spans.ms_a_block("dmr.pick", blocks="dmr.blocks")
