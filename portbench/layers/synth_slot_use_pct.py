"""``synth_slot_use_pct``: the share of the synthesized frame slots
(every channel × the padded steps, ``p25.synth_slots``) that carry a
decoded voice frame (``p25.frames``), the program's counters over the
profiled span."""

from portbench import spans


def read(ctx):
    return spans.pct("p25.frames", "p25.synth_slots", blocks="p25.blocks")
