"""Channel-number to frequency math (host).

The port's own copies of ``IdenTable`` and ``ChannelMap`` of
``dsdneo_tpu/engine/trunk.py``: the P25 iden table, which the TSBK
catalog fills from IDEN_UP messages and reads for its frequency notes,
and the explicit channel map of DMR, NXDN and EDACS systems, through
which the trunked fleet resolves their grants.  The serial trunking
state machines wait for the CLI slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class IdenTable:
    """P25 channel-number → frequency math (reference
    src/protocol/p25/p25_frequency.c iden_up records)."""
    entries: dict = field(default_factory=dict)  # iden -> (base_hz, spacing_hz, offset_hz, tdma_slots)
    version: int = 0        # bumped on change: parse caches key on it

    def add(self, iden: int, base_hz: float, spacing_hz: float,
            offset_hz: float = 0.0, tdma_slots: int = 1) -> None:
        ent = (base_hz, spacing_hz, offset_hz, max(tdma_slots, 1))
        if self.entries.get(iden) != ent:
            self.version += 1
        self.entries[iden] = ent

    def channel_to_freq(self, channel16: int) -> Optional[float]:
        iden = (channel16 >> 12) & 0xF
        chan = channel16 & 0xFFF
        ent = self.entries.get(iden)
        if ent is None:
            return None
        base, spacing, _off, slots = ent
        return base + (chan // slots) * spacing

    def channel_to_slot(self, channel16: int) -> int:
        iden = (channel16 >> 12) & 0xF
        ent = self.entries.get(iden)
        if ent is None:
            return 0
        return (channel16 & 0xFFF) % ent[3]


class ChannelMap:
    """Explicit channel-number → frequency map imported from CSV (DMR
    Tier III / Capacity Plus / Connect Plus / NXDN / EDACS
    '<number>,<frequency Hz>' files)."""

    def __init__(self):
        self.entries: dict[int, float] = {}

    def import_csv(self, path: str) -> int:
        """Header line is skipped; rows are 'channel,frequency_hz[,...]'.
        Returns the number of imported rows."""
        n = 0
        with open(path, errors="replace") as f:
            for row in f:
                parts = [p.strip() for p in row.split(",")]
                if len(parts) < 2:
                    continue
                try:
                    chan = int(parts[0])
                    freq = float(parts[1])
                except ValueError:
                    continue          # header / comment rows
                if freq <= 0:
                    continue
                self.entries[chan] = freq
                n += 1
        return n

    def freq(self, chan: int) -> Optional[float]:
        return self.entries.get(chan)

    def heuristic_fill(self) -> int:
        """DMR Tier III heuristic LCN gap fill: from two or more learned
        LCN → frequency anchors, estimate the per-LCN step, check that
        every anchor fits the linear model exactly, then fill the gaps
        between the lowest and highest known LCN.  Returns the number of
        entries added (0 when the anchors support no confident model)."""
        anchors = sorted((c, f) for c, f in self.entries.items() if c > 0)
        if len(anchors) < 2:
            return 0
        # step estimate: gcd of Δfreq/ΔLCN over adjacent anchors
        step = 0
        for (c0, f0), (c1, f1) in zip(anchors, anchors[1:]):
            d_lcn = c1 - c0
            d_hz = int(round(f1 - f0))
            if d_lcn <= 0 or d_hz <= 0 or d_hz % d_lcn:
                return 0               # non-monotone / fractional step
            step = math.gcd(step, d_hz // d_lcn)
        if step < 1000 or step > 1_000_000:
            return 0                   # implausible channel raster
        base_lcn, base_f = anchors[0]
        for c, f in anchors:           # validate: exact linear fit
            if abs((base_f + (c - base_lcn) * step) - f) > 1.0:
                return 0
        filled = 0
        for c in range(base_lcn + 1, anchors[-1][0]):
            if c not in self.entries:
                self.entries[c] = base_f + (c - base_lcn) * step
                filled += 1
        return filled
