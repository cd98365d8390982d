"""Protocol decoder framework: dibit readers, decode context, registry.

The port's own copy of ``dsdneo_tpu/protocol/base.py``: the event sink
every catalog emits into (``DecodeEvent``, ``DecoderContext``), the
sequential reader the serial decoders walk a channel's dibit and soft
streams with (``DibitReader``, host numpy arrays copied from the device
once), the base class of the protocol decoders and the registry of the
serial decoders keyed by protocol family (``register``, ``registry``).
The batched monitors call the decoders' burst methods directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable

import numpy as np

from dsdneo_tpu_torch.symbols.framesync import SyncHit


@dataclass
class DecodeEvent:
    line: str
    protocol: str
    pos: int                       # symbol index of the owning frame sync
    fields: dict = field(default_factory=dict)


class DecoderContext:
    """Shared cross-frame decode state + event sink (the rebuild's
    equivalent of the reference dsd_state fields used for printing)."""

    def __init__(self, verbose: int = 0, device=None):
        self.events: list[DecodeEvent] = []
        # where the voice is synthesized (the card when None)
        self.device = device
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


class DibitReader:
    """Sequential reader over a channel's dibit/soft stream.

    Handles polarity inversion and (for P25p1) transparent stripping of
    status dibits, which occur at stream positions ≡ 35 (mod 36)
    relative to the frame-sync start (TIA-102.BAAA status symbols;
    reference parity: the NID read skipping in
    src/engine/dispatch/dispatch_p25p1.c:123-141).
    """

    def __init__(self, dibits: np.ndarray, soft: np.ndarray, pos: int,
                 frame_start: int | None = None, strip_status: bool = False,
                 invert: bool = False):
        self.dibits = dibits
        self.soft = soft
        self.pos = pos
        self.frame_start = frame_start if frame_start is not None else pos
        self.strip_status = strip_status
        self.invert = invert
        self.status_dibits: list[int] = []

    def remaining(self) -> int:
        return len(self.dibits) - self.pos

    def _raw_next(self) -> tuple[int, float]:
        d = int(self.dibits[self.pos])
        s = float(self.soft[self.pos])
        self.pos += 1
        if self.invert:
            d ^= 2      # symbol negation: 0↔2 (+1/-1), 1↔3 (+3/-3)
            s = -s
        return d, s

    def next(self) -> tuple[int, float]:
        if self.strip_status:
            while (self.pos - self.frame_start) % 36 == 35:
                d, _ = self._raw_next()
                self.status_dibits.append(d)
        return self._raw_next()

    def read(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Read n data dibits → (dibits uint8 [n], soft float32 [n])."""
        dd = np.empty(n, dtype=np.uint8)
        ss = np.empty(n, dtype=np.float32)
        for i in range(n):
            dd[i], ss[i] = self.next()
        return dd, ss

    def read_bits(self, n_dibits: int) -> tuple[np.ndarray, np.ndarray]:
        """Read dibits → (bits uint8 [2n], per-bit reliab float32 [2n])."""
        dd, ss = self.read(n_dibits)
        bits = np.empty(2 * n_dibits, dtype=np.uint8)
        bits[0::2] = (dd >> 1) & 1
        bits[1::2] = dd & 1
        rel = np.repeat(np.abs(ss), 2).astype(np.float32)
        return bits, rel


class ProtocolDecoder:
    """Base class: one instance per decode session per protocol family."""

    protocol: str = ""

    def handle(self, reader: DibitReader, hit: SyncHit,
               ctx: DecoderContext) -> int:
        """Decode one frame starting just after ``hit``.  Returns the
        absolute symbol index where the engine should resume hunting."""
        raise NotImplementedError


_REGISTRY: dict[str, Callable[[], ProtocolDecoder]] = {}


def register(protocol: str):
    def deco(cls):
        _REGISTRY[protocol] = cls
        return cls
    return deco


def registry() -> dict[str, Callable[[], ProtocolDecoder]]:
    return dict(_REGISTRY)
