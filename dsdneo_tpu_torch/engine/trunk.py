"""P25 channel-number to frequency math (host).

The port's own copy of ``IdenTable`` of ``dsdneo_tpu/engine/trunk.py``,
which the TSBK catalog fills from IDEN_UP messages and reads for its
frequency notes.  The trunking state machines wait for the fleet slice.
"""

from __future__ import annotations

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
