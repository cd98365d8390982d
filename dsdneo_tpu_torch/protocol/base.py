"""Decode events and the per-channel decode context (host).

The port's own copy of ``DecodeEvent``, ``DecoderContext`` and
``ProtocolDecoder`` of ``dsdneo_tpu/protocol/base.py``: the event sink
every catalog emits into, the cross-frame state it reads and writes, and
the base class of the per-channel protocol decoders.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np

@dataclass
class DecodeEvent:
    line: str
    protocol: str
    pos: int                       # symbol index of the owning frame sync
    fields: dict = field(default_factory=dict)


class DecoderContext:
    """Shared cross-frame decode state + event sink (the rebuild's
    equivalent of the reference dsd_state fields used for printing)."""

    def __init__(self, verbose: int = 0):
        self.events: list[DecodeEvent] = []
        self.state = SimpleNamespace(
            nac=0, p2_cc=0, p2_wacn=0, p2_sysid=0, p2_rfssid=0, p2_siteid=0,
            dmr_color_code=-1, nxdn_ran=-1, last_src=0, last_tg=0,
        )
        self.verbose = verbose
        self.audio: dict[int, list[np.ndarray]] = {}   # slot -> pcm chunks

    def emit(self, line: str, protocol: str, pos: int, **fields) -> None:
        self.events.append(DecodeEvent(line, protocol, pos, fields))

    def emit_audio(self, pcm: np.ndarray, slot: int = 0) -> None:
        # -V slot synthesis mask (reference opts->slot1_on/slot2_on)
        mask = getattr(self.state, "slot_mask", 3)
        if slot in (0, 1) and not (mask >> slot) & 1:
            return
        pol = getattr(self.state, "tg_policy", None)
        tg = getattr(self.state, "last_tg", 0) or 0
        if pol is not None and tg and not pol.allows(tg, slot=slot):
            return                      # blocked talkgroup: mute
        gain_db = getattr(self.state, "audio_gain_db", 0.0)
        if gain_db:
            pcm = pcm * (10.0 ** (gain_db / 20.0))
        self.audio.setdefault(slot, []).append(pcm)
        if getattr(self, "call_recorder", None) is not None:
            t = sum(len(c) for c in self.audio[slot]) / 8000.0
            self.call_recorder.add_audio(
                pcm, slot, t,
                talkgroup=getattr(self.state, "last_tg", 0) or 0,
                source=getattr(self.state, "last_src", 0) or 0)

    def frame_info(self) -> str:
        """printFrameInfo-format header segment (reference
        src/core/frames/dsd_frame.c:32-58)."""
        s = self.state
        parts = []
        if s.p2_wacn:
            parts.append(f"WACN: {s.p2_wacn:05X}; ")
        if s.p2_sysid:
            parts.append(f"SYS: {s.p2_sysid:03X}; ")
        if s.p2_cc:
            parts.append(f"NAC/CC: {s.p2_cc:03X}; ")
        else:
            parts.append(f"NAC: {s.nac:03X}; ")
        if s.p2_rfssid:
            parts.append(f"RFSS: {s.p2_rfssid:03d}; ")
        if s.p2_siteid:
            parts.append(f"Site: {s.p2_siteid:03d}; ")
        return "".join(parts)


class ProtocolDecoder:
    """Base class: one instance per decode session per protocol family.
    The serial stream entry point (``handle``, over a dibit reader) waits
    for the port's serial decoders; the batched monitors call the
    decoders' burst methods."""

    protocol: str = ""
