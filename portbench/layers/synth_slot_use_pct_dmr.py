"""``synth_slot_use_pct.dmr``: the share of the synthesized frame slots
(every channel × the padded steps, ``dmr.synth_slots``) that carry a
decoded AMBE+2 frame (``dmr.frames``, 18 a superframe), the DMR
pipeline's counters over the profiled span."""

from portbench import spans


def read(ctx):
    return spans.pct("dmr.frames", "dmr.synth_slots", blocks="dmr.blocks")
