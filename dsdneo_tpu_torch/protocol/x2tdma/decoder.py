"""X2-TDMA decoder (Motorola's pre-standard 2-slot TDMA, P25-adjacent).

Burst geometry mirrors DMR — CACH + two 54-dibit payload halves around a
24-dibit center sync/EMB field — with AMBE+2 voice and P25-style link
control.  A voice call is a 6-burst superframe on one slot (same-slot
period 288 dibits); bursts 1-4 replace the sync with embedded
signalling that spreads either the 72-bit P25 LCW (LCF 8 + MFID 8 +
LCINFO 56) or the encryption sync (72-bit MI + ALG 8 + KID 16) across
fixed dibit positions (reference src/protocol/x2tdma/x2tdma_voice.c
x2tdma_decode_signal_j1..j4; geometry processX2TDMAvoice /
x2tdma_process_slot_iteration).  Data bursts carry a raw colour code +
burst type (x2tdma_data.c x2tdma_read_slot_type).  No reference e2e
fixture exists — docs/testing.md lists X2-TDMA among the known fixture
gaps — so validation is structural/synthetic.

The port's own copy of ``dsdneo_tpu/protocol/x2tdma/decoder.py`` (numpy
only), unchanged in its logic, so both packages give the same results
bit for bit; the voice frames synthesize on ``ctx.device``.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                            ProtocolDecoder, register)
from dsdneo_tpu_torch.symbols.framesync import SyncHit

# burst type table (reference x2tdma_data.c x2tdma_set_fsubtype_from_bursttype)
BURST_TYPES = {
    0b0000: "PI Header", 0b0001: "VOICE Header", 0b0010: "TLC",
    0b0011: "CSBK", 0b0100: "MBC Header", 0b0101: "MBC",
    0b0110: "DATA Header", 0b0111: "RATE 1/2 DATA", 0b1000: "RATE 3/4 DATA",
    0b1001: "Slot idle", 0b1010: "Rate 1 DATA",
}

SLOT_PERIOD = 288           # dibits between same-slot sync fields


def _emb_signal_map(j: int, es: bool) -> list[tuple[str, int] | None]:
    """Embedded-signalling bit targets for burst j in transmission order
    (dibit 4 bit1, bit0, dibit 5 bit1, ... dibit 4k+7 bit1 per 4-dibit
    group; reference x2tdma_decode_signal_j1/j2/j4 bit tables)."""
    out: list[tuple[str, int] | None] = []
    if j == 1:
        for k in range(4):
            if es:
                out += [("mi", k), ("mi", 11 + k), ("mi", 22 + k),
                        ("mi", 32 + k), ("mi", 42 + k), ("mi", 52 + k),
                        ("mi", 62 + k)]
            else:
                out += [("lcf", k), ("mfid", 3 + k), ("lci", 6 + k),
                        ("lci", 16 + k), ("lci", 26 + k), ("lci", 36 + k),
                        ("lci", 46 + k)]
    elif j == 2:
        for k in range(4):
            if es:
                out += [("mi", 4 + k), ("mi", 15 + k), ("mi", 26 + k),
                        ("mi", 36 + k), ("mi", 46 + k), ("mi", 56 + k),
                        ("mi", 66 + k)]
            else:
                out += [("lcf", 4 + k),
                        ("mfid", 7) if k == 0 else ("lci", k - 1),
                        ("lci", 10 + k), ("lci", 20 + k), ("lci", 30 + k),
                        ("lci", 40 + k), ("lci", 50 + k)]
    elif j == 4:
        for k in range(2):
            if es:
                out += [("mi", 8 + k), ("mi", 19 + k), ("mi", 30 + k),
                        ("mi", 40 + k), ("mi", 50 + k), ("mi", 60 + k),
                        ("mi", 70 + k)]
            else:
                out += [("mfid", k), ("lci", 3 + k), ("lci", 14 + k),
                        ("lci", 24 + k), ("lci", 34 + k), ("lci", 44 + k),
                        ("lci", 54 + k)]
        out += [("mi", 10), ("mi", 21)] if es else [("mfid", 2), ("lci", 5)]
    return out


def _emb_bits(dibits24: np.ndarray, n: int) -> list[int]:
    """First n signalling bits from dibits 4.. in (bit1, bit0, ...,
    bit1-of-4th) order per 4-dibit group."""
    out = []
    g = 0
    while len(out) < n:
        base = 4 + 4 * g
        d = dibits24[base:base + 4]
        bits = [(int(d[0]) >> 1) & 1, int(d[0]) & 1,
                (int(d[1]) >> 1) & 1, int(d[1]) & 1,
                (int(d[2]) >> 1) & 1, int(d[2]) & 1,
                (int(d[3]) >> 1) & 1]
        out += bits
        g += 1
    return out[:n]


@register("x2tdma")
class X2TdmaDecoder(ProtocolDecoder):
    protocol = "x2tdma"

    def __init__(self):
        self.vc = {0: 0, 1: 0}

    def _slot_type(self, reader: DibitReader, pos: int) -> tuple[int, int] | None:
        """Raw 3-bit colour code + 4-bit burst type at sync-5..sync
        (reference x2tdma_data.c x2tdma_read_slot_type: no FEC, the
        5th dibit carries a parity bit)."""
        bits = self._bits(reader, pos - 5, 5)
        if bits is None:
            return None
        cc = (int(bits[0]) << 2) | (int(bits[1]) << 1) | int(bits[2])
        bt = (int(bits[4]) << 3) | (int(bits[5]) << 2) | \
             (int(bits[6]) << 1) | int(bits[7])
        return cc, bt

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        pos = hit.pos
        kind = hit.sync.kind
        polarity = "-" if reader.invert else "+"
        if "voice" in kind:
            return self._voice_superframe(reader, hit, ctx, polarity)
        st = self._slot_type(reader, pos)
        detail = ""
        if st is not None:
            cc, bt = st
            name = BURST_TYPES.get(bt, f"Unknown burst type {bt:04b}")
            detail = f" | CC={cc} | {name}"
        ctx.emit(f"Sync: {polarity}X2-TDMA "
                 f"{kind.replace('_', ' ').upper()}{detail}",
                 "x2tdma", pos)
        return pos + 29 + 49

    # -- voice superframe ---------------------------------------------------

    def _voice_superframe(self, reader: DibitReader, hit: SyncHit,
                          ctx: DecoderContext, polarity: str) -> int:
        """Walk the 6-burst voice superframe from the sync burst
        (reference processX2TDMAvoice j=0..5): 3 AMBE frames per burst
        at [s-54,s-18) / [s-18,s)+[s+24,s+42) / [s+42,s+78), embedded
        LC or encryption sync in the center field of bursts 1-4."""
        s0 = hit.pos
        kind = hit.sync.kind
        slot = 0 if "bs" in kind else 1
        self.vc[slot] = self.vc.get(slot, 0) % 6 + 1
        ctx.emit(f"Sync: {polarity}X2-TDMA {kind.replace('_', ' ').upper()}"
                 f" VC{self.vc[slot]}", "x2tdma", s0)

        eeei = aiei = 0
        lcf = np.zeros(8, np.uint8)
        mfid = np.zeros(8, np.uint8)
        lci = np.zeros(56, np.uint8)
        mi = np.zeros(72, np.uint8)
        alg = np.zeros(8, np.uint8)
        kid = np.zeros(16, np.uint8)
        burstd = 0
        got_sig = False
        consumed = s0 + 78

        for j in range(6):
            s = s0 + SLOT_PERIOD * j
            v1 = self._bits(reader, s - 54, 36)
            v2a = self._bits(reader, s - 18, 18)
            v2b = self._bits(reader, s + 24, 18)
            v3 = self._bits(reader, s + 42, 36)
            if v1 is None or v2a is None or v2b is None or v3 is None:
                break
            emb = reader.dibits[s:s + 24].astype(np.uint8)
            if reader.invert:
                emb = emb ^ 2
            if j > 0:
                # a data sync in place of EMB ends the voice superframe
                # (reference x2tdma_update_mute_and_lights)
                if self._is_data_sync(emb):
                    break
                if j <= 4 and not self._is_voice_sync(emb):
                    got_sig = True
                    if j == 1:
                        eeei = int(emb[1]) & 1
                        aiei = (int(emb[2]) >> 1) & 1
                    if j == 3:
                        # ALG from dibits 4-5 (+8-9 when burstd==0), KID
                        # from dibits 10-17, two bits per dibit
                        # (reference x2tdma_decode_signal_j3)
                        burstd = int(emb[1]) & 1
                        bits = _emb_bits(emb, 11)
                        alg[0:4] = bits[0:4]
                        if burstd == 0:
                            alg[4:8] = bits[7:11]
                        for i in range(16):
                            d = emb[10 + i // 2]
                            kid[i] = (int(d) >> (1 - i % 2)) & 1
                    else:
                        es = bool(eeei or aiei)
                        targets = _emb_signal_map(j, es)
                        bits = _emb_bits(emb, len(targets))
                        for t, b in zip(targets, bits):
                            if t is None:
                                continue
                            {"lcf": lcf, "mfid": mfid, "lci": lci,
                             "mi": mi}[t[0]][t[1]] = b
            self._voice(np.concatenate([v1, v2a, v2b, v3]), slot, ctx)
            consumed = s + 78

        if got_sig:
            if eeei or aiei:
                algv = int("".join(map(str, alg)), 2)
                kidv = int("".join(map(str, kid)), 2)
                miv = int("".join(map(str, mi)), 2)
                ctx.emit(f"       X2-TDMA ES - MI: {miv:018X} ALGID: "
                         f"{algv:02X} KID: {kidv:04X}", "x2tdma", s0,
                         alg=algv, kid=kidv)
            else:
                lcfv = int("".join(map(str, lcf)), 2)
                mfv = int("".join(map(str, mfid)), 2)
                detail = f"       X2-TDMA LC - LCF: {lcfv:02X} MFID: {mfv:02X}"
                if lcfv == 0x00:
                    # P25 group-voice LCW layout: lcinfo = LCW bits 16-71
                    tg = int("".join(map(str, lci[16:32])), 2)
                    src = int("".join(map(str, lci[32:56])), 2)
                    ctx.state.last_tg, ctx.state.last_src = tg, src
                    detail += f" Group {tg} Source {src}"
                ctx.emit(detail, "x2tdma", s0, lcf=lcfv, mfid=mfv)
        return consumed

    def _is_data_sync(self, emb: np.ndarray) -> bool:
        return self._match_sync(emb, "data")

    def _is_voice_sync(self, emb: np.ndarray) -> bool:
        return self._match_sync(emb, "voice")

    def _match_sync(self, emb: np.ndarray, want: str) -> bool:
        """Exact (dibit|1) pattern match, the reference's sync-string
        compare (x2tdma_read_sync: sync[i] = (dibit|1) + '0')."""
        from dsdneo_tpu_torch.symbols.framesync import SYNC_DEFS
        got = "".join(str(int(d) | 1) for d in emb)
        for d in SYNC_DEFS:
            if d.protocol == "x2tdma" and want in d.kind and not d.inverted:
                if got == d.pattern:
                    return True
        return False

    def _bits(self, reader, start, n_dib):
        if start < 0 or start + n_dib > len(reader.dibits):
            return None
        dd = reader.dibits[start:start + n_dib].astype(np.uint8)
        if reader.invert:
            dd = dd ^ 2
        bits = np.empty(2 * n_dib, dtype=np.uint8)
        bits[0::2] = (dd >> 1) & 1
        bits[1::2] = dd & 1
        return bits

    def _voice(self, voice216: np.ndarray, slot: int,
               ctx: DecoderContext) -> None:
        from dsdneo_tpu_torch.protocol.dmr.ambe_frame import decode_ambe_ecc
        from dsdneo_tpu_torch.vocoder.mbe import decode_ambe_2450
        from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
        params = []
        for k in range(3):
            bits49, _ = decode_ambe_ecc(voice216[72 * k:72 * (k + 1)])
            params.append(decode_ambe_2450(bits49))
        pcm = synthesize_frames(params, ctx.device)
        if pcm.size:
            ctx.emit_audio(pcm, slot=slot)
