"""NXDN (4800/9600 bps 4-level FSK) RDCH/RCCH decoder.

Frame model (NXDN CAI / OP25 lineage; reference parity
src/protocol/nxdn/nxdn_frame.c): after the 10-symbol FSW the frame is
182 dibits — LICH (8 dibits, sign bits), then 348 payload bits laid out
as SACCH(60) + 2×FACCH/VCH(144).  The whole frame is descrambled by the
PN9 sequence (seed 0xE4: dibit sign flips at fixed positions).

SACCH: 60 bits → 12×5 de-interleave → depuncture (2 of each 12) →
rate-1/2 K=5 Viterbi → 26 data bits (structure 2 + RAN 6 + message 18)
+ CRC6.  Four superframe parts reassemble the 72-bit message (VCALL
etc.; reference src/protocol/nxdn/nxdn_deperm.c / nxdn_element.c).

The port's own copy of ``dsdneo_tpu/protocol/nxdn/decoder.py`` (numpy
only), unchanged in its logic, so both packages give the same results
bit for bit; the voice frames synthesize on ``ctx.device``. The batched
RCCH monitor (``engine.ccbatch.BatchedNxdnControlPipeline``) parses with
the same ``NxdnDecoder._message``.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import conv
from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                      ProtocolDecoder, register)
from dsdneo_tpu_torch.symbols.framesync import SyncHit


def _pn9_scramble_positions(seed: int = 0xE4, n: int = 182) -> np.ndarray:
    """PN9 LFSR (x⁹+x⁵+1 form used by NXDN): positions whose dibit sign
    is inverted (reference src/protocol/nxdn/nxdn_descramble.c)."""
    lfsr = seed
    pos = []
    for i in range(n):
        if lfsr & 1:
            pos.append(i)
        bit = ((lfsr >> 4) ^ lfsr) & 1
        lfsr = (lfsr >> 1) | (bit << 8)
    return np.array(pos, dtype=np.int64)


_SCRAMBLE_POS = _pn9_scramble_positions()

# 12×5 block interleave for the 60-bit SACCH (OP25 PERM_12_5:
# received bit i lands at deinterleaved position (i%5)*12 + i//5)
_PERM_12_5 = np.array([(i % 5) * 12 + i // 5 for i in range(60)], dtype=np.int64)
# FACCH1 / CAC permutations (same family; reference nxdn_const.h
# PERM_16_9 / PERM_12_25)
_PERM_16_9 = np.array([(i % 9) * 16 + i // 9 for i in range(144)], dtype=np.int64)
_PERM_12_25 = np.array([(i % 25) * 12 + i // 25 for i in range(300)], dtype=np.int64)

# LICH option → (voice_frames_mask, facch_mask, sacch, cac) profiles
# (reference nxdn_frame.c k_nxdn_lich_profiles; voice/facch values are
# bitmasks over the two payload halves)
_LICH_PROFILES: dict[int, tuple[int, int, bool, bool]] = {}
for lich in (0x01, 0x05):
    _LICH_PROFILES[lich] = (0, 0, False, True)
for lich in (0x28, 0x29, 0x49):
    _LICH_PROFILES[lich] = (0, 0, False, False)       # udch
for lich in (0x2E, 0x2F, 0x4E, 0x4F):
    _LICH_PROFILES[lich] = (0, 0, False, False)
for lich in (0x32, 0x33, 0x52, 0x53):
    _LICH_PROFILES[lich] = (2, 1, True, False)
for lich in (0x34, 0x35, 0x54, 0x55):
    _LICH_PROFILES[lich] = (1, 2, True, False)
for lich in (0x36, 0x37, 0x56, 0x57):
    _LICH_PROFILES[lich] = (3, 0, True, False)
for lich in (0x20, 0x21, 0x30, 0x31, 0x40, 0x41, 0x50, 0x51):
    _LICH_PROFILES[lich] = (0, 3, True, False)
for lich in (0x38, 0x39):
    _LICH_PROFILES[lich] = (0, 0, True, False)

MESSAGE_LABELS = {
    0x00: " CALL_RESP", 0x01: " VCALL", 0x02: " VCALL_REC_REQ",
    0x03: " VCALL_IV", 0x04: " VCALL_ASSGN", 0x05: " VCALL_ASSGN_DUP",
    0x06: " CALL_CONN_RESP", 0x07: " TX_REL_EX", 0x08: " TX_REL",
    0x09: " DCALL_HEADER", 0x0B: " DCALL_DATA", 0x0C: " DCALL_ACK",
    0x0E: " DCALL_ASSGN", 0x0F: " HEAD_DLY", 0x10: " IDLE", 0x11: " DISC",
    0x17: " DST_ID_INFO", 0x18: " SITE_INFO", 0x19: " SRV_INFO",
    0x1A: " CCH_INFO", 0x1B: " ADJ_SITE_INFO", 0x1C: " FAIL_STAT_INFO",
    0x20: " REG_RESP", 0x24: " GRP_REG_RESP", 0x38: " SDCALL_REQ_HEADER",
    0x39: " SDCALL_REQ_DATA", 0x3B: " SDCALL_RESP",
}

CALL_TYPES = {0: "Broadcast Call", 1: "Group Call", 2: "Idle", 3: "Session Call",
              4: "Private Call", 5: "Reserved", 6: "PSTN Interconnect Call",
              7: "PSTN Speed Dial Call"}

VOICE_MODES = {0: "4800bps/EHR", 2: "9600bps/EHR", 3: "9600bps/EFR",
               8: "4800bps/EHR S:1", 10: "9600bps/EHR S:1", 11: "9600bps/EFR S:1"}


def crc6_nxdn(bits: np.ndarray) -> int:
    """NXDN CRC6 shift-register form (reference nxdn_deperm.c crc6)."""
    s = [1] * 6
    for b in bits:
        a = int(b) ^ s[0]
        s[0] = a ^ s[1]
        s[1] = s[2]
        s[2] = s[3]
        s[3] = a ^ s[4]
        s[4] = a ^ s[5]
        s[5] = a
    v = 0
    for bit in s:
        v = (v << 1) | bit
    return v


def crc12_nxdn(bits: np.ndarray) -> int:
    """NXDN FACCH CRC12 shift-register form (reference nxdn_dcr_utils.c
    crc12f)."""
    s = [1] * 12
    for b in bits:
        a = int(b) ^ s[0]
        s[0] = a ^ s[1]
        s[1:8] = s[2:9]
        s[8] = a ^ s[9]
        s[9] = a ^ s[10]
        s[10] = a ^ s[11]
        s[11] = a
    v = 0
    for bit in s:
        v = (v << 1) | bit
    return v


def crc16_cac(bits: np.ndarray) -> int:
    """NXDN CAC CRC16: init 0xC3EE, poly x^16+x^12+x^5+1, xorout
    0xFFFF; returns 0 for a valid 171-bit block (reference
    nxdn_dcr_utils.c crc16cac)."""
    crc = 0xC3EE
    poly = (1 << 12) + (1 << 5) + 1
    for b in bits:
        crc = ((crc << 1) | int(b)) & 0x1FFFF
        if crc & 0x10000:
            crc = (crc & 0xFFFF) ^ poly
    return (crc ^ 0xFFFF) & 0xFFFF


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


@register("nxdn")
class NxdnDecoder(ProtocolDecoder):
    protocol = "nxdn"

    def __init__(self):
        self.segments = np.ones((4, 18), dtype=np.uint8)
        self.seg_ok = [False] * 4
        self.part_of_frame = -1
        self.last_ran = -1
        self.variant = None  # "NXDN48"/"NXDN96" (set from symbol rate)
        self.alias_blocks = [""] * 4
        self.dcall = None    # data-call assembly state (header → blocks)

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        pos = hit.pos + 10                      # LICH starts after the FSW
        if pos + 182 > len(reader.dibits):
            return len(reader.dibits)
        dd = reader.dibits[pos:pos + 182].astype(np.uint8)
        soft = reader.soft[pos:pos + 182].astype(np.float32)
        if reader.invert:
            dd = dd ^ 2
            soft = -soft
        # descramble: invert dibit sign at PN positions (-_ overrides
        # the PN95 seed, reference state->nxdn_pn95_seed default 228)
        seed = getattr(ctx.state, "nxdn_pn95_seed", None)
        spos = (_SCRAMBLE_POS if seed in (None, 0xE4)
                else _pn9_scramble_positions(int(seed)))
        dd = dd.copy()
        dd[spos] ^= 2
        soft = soft.copy()
        soft[spos] *= -1.0

        lich_full = _bti((dd[:8] >> 1) & 1)
        parity_rx = lich_full & 1
        lich = lich_full >> 1
        nbits = 7 if lich in (0x08, 0x4A, 0x48, 0x46) else 4
        parity = 0
        for k in range(7, 8 - nbits, -1):
            parity ^= (lich_full >> k) & 1
        if parity != parity_rx:
            return pos + 182

        profile = _LICH_PROFILES.get(lich)
        variant = self.variant or getattr(ctx, "mode_name", "") or "NXDN48"
        if variant == "nxdn96":
            variant = "NXDN96"
        elif variant == "nxdn48":
            variant = "NXDN48"
        rf = (lich >> 5) & 0x3
        rf_name = {0: "RCCH", 1: "RTCH", 2: "RDCH"}.get(rf, "RTCH_C")

        bits = np.zeros(364, dtype=np.uint8)
        bits[0::2] = (dd >> 1) & 1
        bits[1::2] = dd & 1
        rel = np.repeat(np.clip(np.abs(soft) / 3.0, 0.05, 1.0), 2).astype(np.float32)

        if profile is None:
            ctx.emit(f"Sync: {variant}  {rf_name} LICH {lich:02X}", "nxdn", hit.pos)
            return pos + 182

        voice, facch, sacch, cac = profile
        kind = ("Voice " if voice and not facch else
                ("Data  " if not voice else f"V{3 - facch}+F{facch} "))
        if not voice and not facch and not sacch and not cac:
            kind = "Data  "

        line = f"Sync: {variant}  {rf_name} {kind}"
        if sacch:
            line += self._sacch(bits[16:76], rel[16:76], ctx, hit)
        if cac:
            line += self._cac(bits[16:316], rel[16:316], ctx)
        if facch:
            # mixed V+F frames (LICH 0x32-0x35/0x52-0x55) carry voice
            # in one half and FACCH1 in the other — decode the FACCH
            # half even when voice is present (TX_REL / VCALL_IV
            # signalling rides in-band during voice)
            for half in (0, 1):
                if facch & (1 << half) and not (voice & (1 << half)):
                    lo = 76 + 144 * half
                    line += self._facch1(bits[lo:lo + 144],
                                         rel[lo:lo + 144], ctx)
        ctx.emit(line, "nxdn", hit.pos, lich=lich)
        if voice:
            ctx.events[-1].fields["voice_bits"] = bits[76:364]
            self._voice(dd, voice, ctx)
        return pos + 182

    # -- FACCH1 / CAC -------------------------------------------------------
    def _facch1(self, bits144, rel144, ctx: DecoderContext) -> str:
        """FACCH1: PERM_16_9 depermute → 3:4 depuncture → K=5 Viterbi →
        80 element bits + CRC12 (reference nxdn_deperm.c
        nxdn_deperm_facch_soft, nxdn_dcr_utils.c crc12f)."""
        deperm = np.zeros(144, dtype=np.float32)
        deperm_rel = np.zeros(144, dtype=np.float32)
        deperm[_PERM_16_9] = bits144
        deperm_rel[_PERM_16_9] = rel144
        sym = np.zeros(192, dtype=np.float32)
        wt = np.zeros(192, dtype=np.float32)
        for k in range(48):
            sym[4 * k] = deperm[3 * k]
            wt[4 * k] = deperm_rel[3 * k]
            sym[4 * k + 2] = deperm[3 * k + 1]
            wt[4 * k + 2] = deperm_rel[3 * k + 1]
            sym[4 * k + 3] = deperm[3 * k + 2]
            wt[4 * k + 3] = deperm_rel[3 * k + 2]
        dec = conv.decode_soft(sym, wt, nbits=92)
        if crc12_nxdn(dec[:80]) != _bti(dec[80:92]):
            return " FACCH1 CRC ERR"
        return " FACCH1" + self._message(dec[:80], ctx)

    def _cac(self, bits300, rel300, ctx: DecoderContext) -> str:
        """RCCH CAC: PERM_12_25 depermute → 12:14 depuncture → Viterbi →
        171 bits incl. CRC16 (reference nxdn_deperm_cac_soft)."""
        deperm = np.zeros(300, dtype=np.float32)
        deperm_rel = np.zeros(300, dtype=np.float32)
        deperm[_PERM_12_25] = bits300
        deperm_rel[_PERM_12_25] = rel300
        sym = np.zeros(350, dtype=np.float32)
        wt = np.zeros(350, dtype=np.float32)
        src = 0
        mapping = [0, 1, 2, None, 3, 4, 5, 6, 7, 8, 9, None, 10, 11]
        for grp in range(25):
            for i, m in enumerate(mapping):
                if m is not None:
                    sym[grp * 14 + i] = deperm[grp * 12 + m]
                    wt[grp * 14 + i] = deperm_rel[grp * 12 + m]
        dec = conv.decode_soft(sym, wt, nbits=171)
        if crc16_cac(dec[:171]) != 0:
            return " CAC CRC ERR"
        ran = _bti(dec[2:8])
        self.last_ran = ran
        ctx.state.nxdn_ran = ran
        return f" CAC RAN {ran:02d}" + self._message(dec[8:155], ctx)

    def _voice(self, dd: np.ndarray, voice: int, ctx: DecoderContext) -> None:
        """AMBE frames at dibits 38+36k of the descrambled frame
        (reference src/protocol/nxdn/nxdn_voice.c); voice mask 1=first
        half, 2=second, 3=both."""
        from dsdneo_tpu_torch.protocol.dmr.ambe_frame import decode_ambe_ecc
        from dsdneo_tpu_torch.vocoder.mbe import decode_ambe_2450
        from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
        start = 0 if voice in (1, 3) else 2
        stop = 2 if voice == 1 else 4
        params = []
        for k in range(start, stop):
            seg = dd[38 + 36 * k: 38 + 36 * (k + 1)]
            bits72 = np.empty(72, dtype=np.uint8)
            bits72[0::2] = (seg >> 1) & 1
            bits72[1::2] = seg & 1
            bits49, _errs = decode_ambe_ecc(bits72)
            params.append(decode_ambe_2450(bits49))
        pcm = synthesize_frames(params, ctx.device)
        if pcm.size:
            ctx.emit_audio(pcm, slot=0)

    # -- SACCH ------------------------------------------------------------
    def _sacch(self, bits60, rel60, ctx: DecoderContext, hit: SyncHit) -> str:
        deperm = np.zeros(60, dtype=np.float32)
        deperm_rel = np.zeros(60, dtype=np.float32)
        deperm[_PERM_12_5] = bits60
        deperm_rel[_PERM_12_5] = rel60
        # depuncture: each 10 deperm bits → 12 symbols, zeros at 5 and 11
        sym = np.zeros(72, dtype=np.float32)
        wt = np.zeros(72, dtype=np.float32)
        src = 0
        for blk in range(6):
            for i in range(12):
                if i in (5, 11):
                    continue
                sym[blk * 12 + i] = deperm[src]
                wt[blk * 12 + i] = deperm_rel[src]
                src += 1
        dec = conv.decode_soft(sym, wt, nbits=32)
        crc = crc6_nxdn(dec[:26])
        check = _bti(dec[26:32])
        sf = _bti(dec[0:2])
        part = {2: 1, 1: 2, 0: 3}.get(sf, 0)
        valid_seq = (crc == check)
        out = ""
        if crc == check:
            ran = _bti(dec[2:8])
            self.last_ran = ran
            ctx.state.nxdn_ran = ran
            self.seg_ok[part] = True
            self.segments[part] = dec[8:26]
            out += f" RAN {ran:02d} PF {part + 1}/4"
        else:
            out += f" RAN {self.last_ran:02d}" if self.last_ran >= 0 else "       "
            out += " PF X/4"
            self.seg_ok = [False] * 4
        if part == 3:
            if all(self.seg_ok):
                out += self._full_sacch(ctx, hit)
            self.seg_ok = [False] * 4
        return out

    def _full_sacch(self, ctx: DecoderContext, hit: SyncHit) -> str:
        return self._message(self.segments.reshape(-1), ctx)

    def _message(self, msg: np.ndarray, ctx: DecoderContext) -> str:
        mtype = _bti(msg[2:8])
        label = MESSAGE_LABELS.get(mtype, f" MSG {mtype:02X}")
        out = label
        if mtype in (0x01, 0x07, 0x08, 0x11):    # VCALL family
            cc_option = _bti(msg[8:16])
            call_type = _bti(msg[16:19])
            vco = _bti(msg[19:24])
            src = _bti(msg[24:40])
            dst = _bti(msg[40:56])
            ctx.state.last_src, ctx.state.last_tg = src, dst
            parts = []
            if cc_option & 0x80:
                parts.append("Emergency ")
            ct = CALL_TYPES.get(call_type, "Unknown Call Type")
            vm = VOICE_MODES.get(vco & 0xF, f"Reserved {vco & 0xF:X}")
            duplex = "Duplex" if vco & 0x10 else "Half Duplex"
            if mtype == 0x01:
                opt = f"{duplex} {vm} ({vco:02X}) - "
            elif mtype == 0x08:
                opt = "  Transmission Release  - "
            elif mtype == 0x07:
                opt = "Transmission Release Ex - "
            else:
                opt = "       Disconnect       - "
            detail = (f"\n {''.join(parts)}{ct} - {opt}"
                      f"Src={src & 0xFFFF} - Dst/TG={dst & 0xFFFF} ")
            out += detail
        elif mtype in (0x04, 0x05, 0x0E):        # VCALL/DCALL assignment
            # (reference nxdn_element.c nxdn_vcall_assgn_parse: channel
            # at bit 62, 10 bits; grant feeds the trunk follower)
            cc_option = _bti(msg[8:16])
            call_type = _bti(msg[16:19])
            vco = _bti(msg[19:24])
            src = _bti(msg[24:40])
            dst = _bti(msg[40:56])
            chan = _bti(msg[62:72]) if len(msg) >= 72 else 0
            ctx.state.last_src, ctx.state.last_tg = src, dst
            parts = []
            if cc_option & 0x80:
                parts.append("Emergency ")
            if cc_option & 0x40:
                parts.append("Visitor ")
            ct = CALL_TYPES.get(call_type, "Unknown Call Type")
            if mtype == 0x0E:
                opt = f"   Data Call Assignment ({vco:02X}) - "
            else:
                vm = VOICE_MODES.get(vco & 0xF, f"Reserved {vco & 0xF:X}")
                duplex = "Duplex" if vco & 0x10 else "Half Duplex"
                opt = f"{duplex} {vm} ({vco:02X}) - "
            out += (f"\n {''.join(parts)}{ct} - {opt}"
                    f"Src={src & 0xFFFF} - Dst/TG={dst & 0xFFFF} "
                    f"- Channel [{chan & 0x3FF:03X}][{chan & 0x3FF:04d}] ")
            ctx.emit(f"       NXDN {label.strip()} CH {chan & 0x3FF}"
                     f" TG {dst} SRC {src}", "nxdn", 0,
                     tg=dst, src=src, lpcn=chan & 0x3FF,
                     grant=chan not in (0, 0x3FF),
                     data=mtype == 0x0E,
                     emergency=bool(cc_option & 0x80))
        elif mtype == 0x19 and len(msg) >= 72:   # SRV_INFO
            loc = _bti(msg[8:32])
            svc = _bti(msg[32:48])
            rst = _bti(msg[48:72])
            out += (f"\n Service Information - Location ID [{loc:06X}]"
                    f" SVC [{svc:04X}] RST [{rst:06X}]")
        elif mtype == 0x1A and len(msg) >= 64:   # CCH_INFO
            loc = _bti(msg[8:32])
            sts = _bti(msg[32:38])
            ch1 = _bti(msg[38:48])
            ch2 = _bti(msg[54:64])
            out += (f"\n Control Channel Information - Location ID"
                    f" [{loc:06X}] STS [{sts:02X}] CH1 [{ch1}] CH2 [{ch2}]")
            ctx.emit(f"       NXDN CCH_INFO CH1 {ch1} CH2 {ch2}", "nxdn", 0,
                     neighbors=[c for c in (ch1, ch2) if 0 < c < 0x3FF])
        elif mtype in (0x09, 0x38):              # DCALL/SDCALL header
            # short-data / data call header (reference nxdn_element.c
            # nxdn_sdcall_header: cc@8, type@16:3, opt@19:5, src@24:16,
            # dst@40:16, cipher@56:2, kid@58:6, blocks@68:4, pad@72:5)
            cc_option = _bti(msg[8:16])
            call_type = _bti(msg[16:19])
            src = _bti(msg[24:40])
            dst = _bti(msg[40:56])
            cipher = _bti(msg[56:58])
            kid = _bti(msg[58:64])
            ctx.state.last_src, ctx.state.last_tg = src, dst
            out += (f"\n {CALL_TYPES.get(call_type, '?')} -"
                    f" Src={src} - Dst/TG={dst}")
            if cc_option:
                out += f" CC [{cc_option:02X}]"
            if len(msg) >= 77:
                blocks = _bti(msg[68:72])
                pad = _bti(msg[72:77])
                out += f" Blocks [{blocks}] Pad [{pad}]"
                # start data-call assembly (reference
                # nxdn_dcall_header_apply)
                self.dcall = {"blocks": max(blocks, 1), "pad": pad,
                              "buf": np.zeros(24 * 128, np.uint8)}
            if cipher:
                names = {1: "Scrambler", 2: "DES", 3: "AES"}
                out += f" {names.get(cipher, '?')} Key [{kid:02X}]"
        elif mtype in (0x0B, 0x39):              # DCALL/SDCALL data
            # PF/BLK counters at bits 8-15, payload from bit 16
            # (reference nxdn_dcall_prepare); printable ASCII + hex
            # dump matches its payload print (full CRC32 fragment
            # reassembly is the reference's dcall_data)
            pf = _bti(msg[8:12])
            blk = _bti(msg[12:16])
            nbytes = (len(msg) - 16) // 8
            data = [_bti(msg[16 + 8 * i:24 + 8 * i]) for i in range(nbytes)]
            hexs = "".join(f"{b:02X}" for b in data)
            txt = "".join(chr(b) if 0x20 <= b <= 0x7E else "." for b in data)
            out += f"\n  PF [{pf}] BLK [{blk}] DATA [{hexs}] [{txt}]"
            if len(data) > 2 and data[0] == 0x06 and data[1] in (0x24, 0x21):
                # opcode 0x06 + '$'/'!' = ASCII NMEA location
                # (reference nxdn_dcall_handle_crc_ok)
                from dsdneo_tpu_torch.protocol.nmea import nmea_sentence_check
                out += "\n " + nmea_sentence_check(
                    np.asarray(data[1:], np.uint8))
            out += self._dcall_data(msg, pf, blk)
        elif mtype == 0x3F:                      # proprietary form / alias
            out = self._alias(msg, ctx) or " PROP_FORM"
        elif mtype == 0x18 and len(msg) >= 144:  # SITE_INFO (RCCH)
            loc = _bti(msg[8:32])
            cs_info = _bti(msg[32:48])
            svc = _bti(msg[48:64])
            rst = _bti(msg[64:88])
            ca = _bti(msg[88:112])
            ver = _bti(msg[112:120])
            adj = _bti(msg[120:124])
            ch1 = _bti(msg[124:134])
            out += (f"\n Location ID [{loc:06X}] CSC [{cs_info:04X}]"
                    f" SVC [{svc:04X}] RST [{rst:06X}]"
                    f"\n          CA [{ca:06X}] V[{ver:X}] ADJ [{adj:01X}]"
                    f" CH1 [{ch1}]")
        elif mtype == 0x1B and len(msg) >= 80:   # ADJ_SITE_INFO
            loc = _bti(msg[8:32])
            ch = _bti(msg[36:46])
            out += f"\n Adjacent Location ID [{loc:06X}] CH [{ch}]"
        return out

    def _dcall_data(self, msg: np.ndarray, pf: int, blk: int) -> str:
        """Data-call block reassembly + CRC32 dispatch (reference
        nxdn_element.c nxdn_dcall_prepare/nxdn_dcall_data: blocks count
        down, each contributes byte_len octets at
        byte_len*(header_blocks-blk); block 0 closes the PDU with a
        CRC32 over everything but the last 32 bits).  byte_len is 20
        (non-Type-D systems, data_header_format 0)."""
        st = self.dcall
        if st is None:
            return " Missing or Invalid Header;"
        byte_len = 20
        block_bits = 8 * byte_len
        if blk > st["blocks"]:
            self.dcall = None
            return f" Block Num Exceeds Header Reported ({blk});"
        if pf != blk:
            self.dcall = None
            return " Partial Selective Retry, Previous Delivery" \
                   " Not Retained in Memory;"
        if len(msg) < 16 + block_bits:
            self.dcall = None
            return f" Data Call Frame Too Short ({len(msg)} bits);"
        ptr = block_bits * (st["blocks"] - blk)
        if ptr + block_bits > len(st["buf"]):
            self.dcall = None
            return " PDU Assembly Pointer Out of Range;"
        st["buf"][ptr:ptr + block_bits] = msg[16:16 + block_bits]
        if pf != 0:
            return ""
        total_bytes = (st["blocks"] + 1) * byte_len - st["pad"]
        self.dcall = None
        if total_bytes < 4 or total_bytes * 8 > len(st["buf"]):
            return " Total Bytes Out of Range;"
        buf = st["buf"][:total_bytes * 8]
        ext = _bti(buf[-32:])
        chk = _nxdn_crc32(buf[:-32])
        if ext != chk:
            return f"\n  Data Call CRC32 ERR ({ext:08X}/{chk:08X})"
        opcode = _bti(buf[0:8])
        first = _bti(buf[8:16])
        if opcode == 0x06 and first in (0x24, 0x21):
            from dsdneo_tpu_torch.protocol.nmea import nmea_sentence_check
            data = np.array([_bti(buf[8 * i:8 * i + 8])
                             for i in range(1, total_bytes)], np.uint8)
            return "\n " + nmea_sentence_check(data)
        if _bti(buf[0:24]) == 0:
            # byte-reversed Kenwood position report (reference
            # nxdn_dcall_handle_reverse_gps: bytes total-5 down to 0,
            # 0xFFFC marker, fields after)
            rev = []
            for i in range(total_bytes - 5, -1, -1):
                rev.append(_bti(buf[8 * i:8 * i + 8]))
            bits = np.unpackbits(np.array(rev, np.uint8))
            if len(bits) >= 16 and _bti(bits[0:16]) == 0xFFFC:
                return "\n " + _nxdn_gps_report(bits[16:])
        return "\n  Data Call complete; CRC32 OK"

    def _alias(self, msg: np.ndarray, ctx: DecoderContext) -> str | None:
        """Kenwood standard alias (MFID 0x68, subtype 0x8204): 4 blocks
        of 4 ASCII chars (reference nxdn_alias_decode.c
        nxdn_alias_decode_prop)."""
        mfid = _bti(msg[8:16])
        subtype = _bti(msg[16:32])
        if mfid != 0x68 or subtype != 0x8204:
            return None
        block = _bti(msg[32:36])
        total = _bti(msg[36:40])
        if not (1 <= block <= 4):
            return " ALIAS"
        if not (1 <= total <= 4):
            total = 4
        chars = []
        for i in range(4):
            b = _bti(msg[40 + 8 * i:48 + 8 * i])
            chars.append(chr(b) if 0x20 <= b <= 0x7E else " ")
        self.alias_blocks[block - 1] = "".join(chars)
        alias = "".join(self.alias_blocks[:total]).rstrip()
        if alias:
            ctx.state.last_alias = alias
            return f" ALIAS\n Talker Alias: {alias}"
        return " ALIAS"


def _nxdn_crc32(bits: np.ndarray) -> int:
    """NXDN data-call CRC32: MSB-first 0x04C11DB7, init 0xFFFFFFFF, no
    final XOR (reference nxdn_crc.c nxdn_crc32_bits)."""
    crc = 0xFFFFFFFF
    for b in bits:
        fb = ((crc >> 31) & 1) ^ int(b)
        crc = (crc << 1) & 0xFFFFFFFF
        if fb:
            crc ^= 0x04C11DB7
    return crc


def _nxdn_gps_report(b: np.ndarray) -> str:
    """Kenwood NXDN position report after the 0xFFFC marker
    (reference dsd_gps.c nxdn_gps_report:865-931; DDMM.mmmm packed
    lat/lon, 0.1-unit speed/heading, date+time fields)."""
    if len(b) < 258:
        b = np.concatenate([np.asarray(b, np.uint8),
                            np.zeros(258 - len(b), np.uint8)])
    elev = _bti(b[56:72])
    if elev >= 0x8000:
        elev -= 0x10000
    speed = _bti(b[74:88]) / 10.0
    heading = _bti(b[92:104]) / 10.0
    year = _bti(b[136:143]) + 2000
    month = _bti(b[143:147])
    day = _bti(b[147:152]) + 1
    hour = _bti(b[247:252])
    minute = _bti(b[252:258])
    lon_degmin = _bti(b[152:168])
    lon_frac = _bti(b[16:31])
    lon_hem = int(b[183])
    lon_minutes = (lon_degmin % 100) + lon_frac / 10000.0
    # DDMM: integer degrees + minutes/60 (float /100 would double-count
    # the MM part as fractional degrees — up to 0.59 deg of error)
    lon = (lon_degmin // 100) + lon_minutes / 60.0
    if lon_hem:
        lon = -lon
    lat_degmin = _bti(b[184:200])
    lat_frac = _bti(b[200:215])
    lat_hem = int(b[215])
    lat_minutes = (lat_degmin % 100) + lat_frac / 10000.0
    lat = (lat_degmin // 100) + lat_minutes / 60.0
    if lat_hem:
        lat = -lat
    if abs(lat) > 90.0 or abs(lon) > 180.0:
        return " GPS: Invalid NXDN position report;"
    return (f" GPS: ({lat:.6f}, {lon:.6f}) Speed: {speed:.1f} k/h;"
            f" COG: {heading:.1f}; Elevation: {elev};"
            f" Date: {year:04d}/{month:02d}/{day:02d};"
            f" Time: {hour:02d}:{minute:02d};")
