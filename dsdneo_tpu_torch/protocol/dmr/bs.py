"""DMR base-station burst decoder (2-slot TDMA, ETSI TS 102 361-1/-4).

Burst geometry relative to the 24-dibit sync field at ``hit.pos``
(reference parity: src/protocol/dmr/dmr_data.c:120-246 — CACH at
sync-66 dibits, payload halves 49 dibits each, slot type 5 dibits
either side of sync):

  [CACH 12][payload 49][slot-type 5][SYNC 24][slot-type 5][payload 49]
   pos-66    pos-54      pos-5        pos      pos+24       pos+29

Polarity ambiguity: DMR's BS voice and BS data sync words are symbol-wise
complements (0x755FD7DF75F7 vs 0xD5D7F77FD757), so a voice-pattern hit on
an inverted channel is really a data burst and vice versa.  Each hit is
decoded under the data hypothesis first (validated by the slot-type
Golay(20,8)); failing that, it is treated as voice.  The reference
resolves the same ambiguity through its polarity state machine in
src/dsp/dsd_frame_sync.c.

The port's own copy of ``dsdneo_tpu/protocol/dmr/bs.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit; every helper it imports inside a method is the port's, and the
voice frames synthesize on ``ctx.device``.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import blockcodes, bptc, crc
from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                            ProtocolDecoder, register)
from dsdneo_tpu_torch.symbols.framesync import SyncHit

# CACH bit interleave (ETSI TS 102 361-1 7.1.4; same table in reference
# src/protocol/dmr/dmr_cach.c:9)
CACH_INTERLEAVE = np.array([0, 7, 8, 9, 1, 10, 11, 12, 2, 13, 14, 15, 3, 16,
                            4, 17, 18, 19, 5, 20, 21, 22, 6, 23], dtype=np.int64)

DATA_TYPES = {
    0: "PI Header", 1: "VLC Header", 2: "TLC", 3: "CSBK", 4: "MBC Header",
    5: "MBC Continuation", 6: "Data Header", 7: "R12DATA", 8: "R34DATA",
    9: "Idle", 10: "R1DATA", 11: "USBD",
}



def _bits_to_int(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


@register("dmr")
class DmrBsDecoder(ProtocolDecoder):
    protocol = "dmr"

    def __init__(self):
        from dsdneo_tpu_torch.protocol.dmr.data import PduAssembler
        self.color_code = -1
        self.vc_counter = {0: 0, 1: 0}
        self.assembler = {0: PduAssembler(), 1: PduAssembler()}
        self.alias = {}
        from dsdneo_tpu_torch.protocol.dmr.slc import SlcAssembler
        self.slc = SlcAssembler()
        self._slc_line: str | None = None
        self._emb_cc_votes: dict[int, int] = {}
        # per-slot voice crypto (reference payload_algid/mi + dropL/R)
        # and late-entry MI fragment store (dmr_le.c)
        self.crypto = {0: {"alg": 0, "kid": 0, "mi": 0, "drop": 256},
                       1: {"alg": 0, "kid": 0, "mi": 0, "drop": 256}}
        # multi-block control assembly: header + continuation payloads
        # per slot (reference dmr_block.c dmr_pdu_sf aggregation)
        self.mbc = {0: None, 1: None}
        self.le_frags = np.zeros((2, 7, 3), np.uint8)

    def _emb_raw_cc(self, reader: DibitReader, pos: int,
                    invert: bool) -> int | None:
        """Raw EMB QR(16,7,6) color-code reading at the voice-hypothesis
        positions (no validity gate beyond single-error correction)."""
        a = self._slice_bits(reader, pos - 4, 4, invert)
        b = self._slice_bits(reader, pos + 24, 4, invert)
        if a is None or b is None:
            return None
        msg, errs = blockcodes.qr_16_7_6().decode(np.concatenate([a, b]))
        if errs > 1:
            return None
        return (msg >> 3) & 0xF

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _slice_bits(reader: DibitReader, start: int, n_dibits: int,
                    invert: bool) -> np.ndarray | None:
        """Absolute dibit range → bit array (with polarity inversion)."""
        if start < 0 or start + n_dibits > len(reader.dibits):
            return None
        dd = reader.dibits[start:start + n_dibits].astype(np.uint8)
        if invert:
            dd = dd ^ 2
        bits = np.empty(2 * n_dibits, dtype=np.uint8)
        bits[0::2] = (dd >> 1) & 1
        bits[1::2] = dd & 1
        return bits

    def _cach_slot(self, reader: DibitReader, pos: int, invert: bool) -> int | None:
        """Decode CACH TACT → slot (0/1) or None on FEC failure; feeds
        the 17 SLC payload bits to the short-LC assembler keyed by the
        LCSS field (reference dmr_cach)."""
        bits = self._slice_bits(reader, pos - 66, 12, invert)
        if bits is None:
            return None
        cach = np.zeros(24, dtype=np.uint8)
        cach[CACH_INTERLEAVE] = bits
        h = blockcodes.hamming_7_4()
        msg, errs = h.decode(cach[:7])
        if errs > 1:
            return None
        tact = h.codebook[msg]           # AT(1) TC(1) LCSS(2)
        lcss = (int(tact[2]) << 1) | int(tact[3])
        self._slc_line = self.slc.feed(lcss, cach[7:24])
        return int(tact[1])

    # -- entry ------------------------------------------------------------
    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        kind = hit.sync.kind
        pos = hit.pos
        base_invert = reader.invert
        if kind == "ms_rc":
            self._rc_burst(reader, hit, ctx, base_invert)
            return pos + 36
        # MS (mobile station) and DM (direct mode) bursts have no usable
        # CACH and carry a single mono stream (reference dmr_ms.c dmrMS /
        # dmrMSData, dmr_rc.c dmrRC)
        mono = kind.startswith(("ms_", "dm_"))
        is_voice_pattern = "voice" in kind

        # data hypothesis: voice-pattern hit on an inverted channel is data
        data_invert = base_invert ^ is_voice_pattern
        st = self._slot_type(reader, pos, data_invert)
        if st is not None:
            cc, dtype = st
            self._data_burst(reader, hit, ctx, data_invert, cc, dtype,
                             mono=mono)
        else:
            voice_invert = base_invert ^ (not is_voice_pattern)
            self._voice_burst(reader, hit, ctx, voice_invert, mono=mono)
        return pos + 29 + 49    # end of second payload half

    # -- reverse channel (standalone RC burst) -----------------------------
    # RC single-burst BPTC interleave tables (ETSI TS 102 361-1 B.2.2.2;
    # reference copies src/fec/bptc.c:33-38)
    _RC_DEINT = np.array([0, 17, 2, 19, 4, 21, 6, 23, 8, 25, 10, 27, 12, 29,
                          14, 31, 16, 1, 18, 3, 20, 5, 22, 7, 24, 9, 26, 11,
                          28, 13, 30, 15], dtype=np.int64)
    _RC_PLACE = np.array([0, 16, 1, 17, 2, 18, 3, 19, 4, 20, 5, 21, 6, 22,
                          7, 23, 8, 24, 9, 25, 10, 26, 11, 27, 12, 28, 13,
                          29, 14, 30, 15, 31], dtype=np.int64)
    _RC_NAMES = {0: "Increase Power By One Step",
                 1: "Decrease Power By One Step",
                 2: "Set Power To Highest", 3: "Set Power To Lowest",
                 4: "Cease Transmission Command",
                 5: "Cease Transmission Request"}

    @staticmethod
    def _crc7_rc(bits4) -> int:
        """ETSI TS 102 361-1 B.3.12 CRC-7 (poly x^7+x^5+x^2+x+1) over the
        4 RC command bits."""
        buf = [int(b) for b in bits4] + [0] * 7
        poly = (1, 0, 1, 0, 0, 1, 1, 1)
        for i in range(len(bits4)):
            if buf[i]:
                for j in range(8):
                    buf[i + j] ^= poly[j]
        v = 0
        for b in buf[len(bits4):len(bits4) + 7]:
            v = (v << 1) | b
        return v

    def _rc_burst(self, reader: DibitReader, hit: SyncHit,
                  ctx: DecoderContext, invert: bool) -> None:
        """Standalone Reverse Channel burst: EMB (QR 16,7,6) either side
        of sync, 32-bit RC PDU = Hamming(16,11,4) row + odd column parity
        (reference dmr_rc.c dmrRC; geometry RC_a/EMB_a/SYNC/EMB_b/RC_b =
        8/4/24/4/8 dibits)."""
        pos = hit.pos
        rc_a = self._slice_bits(reader, pos - 12, 8, invert)
        emb_a = self._slice_bits(reader, pos - 4, 4, invert)
        emb_b = self._slice_bits(reader, pos + 24, 4, invert)
        rc_b = self._slice_bits(reader, pos + 28, 8, invert)
        polarity = "-" if invert else "+"
        if any(x is None for x in (rc_a, emb_a, emb_b, rc_b)):
            return
        emb16 = np.concatenate([emb_a, emb_b])
        qr = blockcodes.qr_16_7_6()
        msg, errs = qr.decode(emb16)
        emb_ok = errs <= 1
        cc_s = f"{(msg >> 3) & 0xF:02d}" if emb_ok else "XX"

        # de-interleave the 32-bit RC BPTC matrix
        inter = np.concatenate([rc_a, rc_b])
        mat = np.zeros(32, dtype=np.uint8)
        mat[self._RC_PLACE[self._RC_DEINT]] = inter
        ham = blockcodes.hamming_16_11_4()
        m, herr = ham.decode(mat[:16])
        out = ham.codebook[m]
        # odd column parity: row2 must be the complement of row1
        parity_err = int(np.sum(out == mat[16:32]))
        fec_ok = herr <= 1 and parity_err == 0
        line = f"Sync: {polarity}DMR RC | Color Code={cc_s} "
        if fec_ok:
            cmd = _bits_to_int(out[0:4])
            crc_got = _bits_to_int(out[4:11]) ^ 0x7A
            if crc_got == self._crc7_rc(out[0:4]):
                name = self._RC_NAMES.get(cmd, f"Reserved {cmd:02X}")
                line += f"| RC: {name};"
                ctx.emit(line, "dmr", pos, rc_command=cmd)
                return
            line += "| RC CRC ERR"
        else:
            line += "| RC FEC ERR"
        ctx.emit(line, "dmr", pos)

    def _slot_type(self, reader: DibitReader, pos: int, invert: bool
                   ) -> tuple[int, int] | None:
        st_pre = self._slice_bits(reader, pos - 5, 5, invert)
        st_suf = self._slice_bits(reader, pos + 24, 5, invert)
        if st_pre is None or st_suf is None:
            return None
        gol = blockcodes.golay_20_8()
        msg, errs = gol.decode(np.concatenate([st_pre, st_suf]))
        if errs > 2:
            return None
        cc = (msg >> 4) & 0xF
        dtype = msg & 0xF
        if dtype > 11:      # reference profiles end at 0x0B USBD
            return None
        return cc, dtype

    # -- data bursts ------------------------------------------------------
    def _data_burst(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext,
                    invert: bool, cc: int, dtype: int,
                    mono: bool = False) -> None:
        pos = hit.pos
        self.color_code = cc
        ctx.state.dmr_color_code = cc
        polarity = "-" if invert else "+"
        name = DATA_TYPES.get(dtype, f"DT{dtype:X}")
        if mono:
            # MS/DM bursts: no usable CACH, one mono stream
            s = 0
            head = (f"Sync: {polarity}DMR MS/DM MODE/MONO "
                    f"| Color Code={cc:02d} | {name}")
        else:
            slot = self._cach_slot(reader, pos, invert)
            s = slot if slot is not None else 0
            lights = ["[slot1]", " slot2 "] if s == 0 else [" slot1 ", "[slot2]"]
            head = (f"Sync: {polarity}DMR {lights[0]} {lights[1]} "
                    f"| Color Code={cc:02d} | {name}")

        # strict-compat observability: the reference prints the CC its
        # EMB-confidence module locked (2 consistent QR(16,7,6) decodes
        # at the voice-hypothesis read position).  Surface that raw
        # reading as ctx.state.dmr_cc_emb_lock alongside the validated
        # CC; on the misacquired fixtures it stays None because the
        # reference's "02" only arises at misaligned positions of its
        # serial re-acquisition (PARITY.md "Color Code=02").
        cc_emb = self._emb_raw_cc(reader, pos, not invert)
        if cc_emb is not None and cc_emb != cc:
            self._emb_cc_votes[cc_emb] = self._emb_cc_votes.get(cc_emb, 0) + 1
            if self._emb_cc_votes[cc_emb] >= 2:
                ctx.state.dmr_cc_emb_lock = cc_emb

        h1 = self._slice_bits(reader, pos - 54, 49, invert)
        h2 = self._slice_bits(reader, pos + 29, 49, invert)
        if h1 is None or h2 is None:
            ctx.emit(head, "dmr", pos, cc=cc, dtype=dtype)
            return
        burst = np.concatenate([h1, h2])
        detail = ""
        if dtype == 8:                      # rate 3/4 data: trellis coded
            detail = self._r34_block(burst, s)
        elif dtype == 10:                   # rate 1: UNCODED payload
            # reference dmr_dburst.c [0x0A] R_1U: full 196-bit burst,
            # 24 data octets, no FEC — running it through BPTC(196,96)
            # always failed and rate-1 PDUs never assembled
            detail = self._r1_block(burst, s)
        else:
            payload, errors = bptc.bptc_196_96_decode(burst)
            if errors == 0:
                if dtype == 3:
                    detail = self._csbk(payload, ctx, hit, s, mono)
                elif dtype == 4:
                    # MBC header (CRC mask 0xAAAA, reference
                    # dmr_dburst.c): start aggregation; decode
                    # completes when the LB-flagged continuation comes
                    hcrc = crc.crc16_bits(payload[:80], init=0,
                                          xorout=0xFFFF) ^ 0xAAAA
                    if hcrc != _bits_to_int(payload[80:96]):
                        self.mbc[s] = None
                        detail = " | MBC Header CRC ERR"
                    else:
                        self.mbc[s] = [payload]
                        detail = " | MBC Header"
                elif dtype == 5:
                    detail = self._mbc_continuation(payload, ctx, hit, s,
                                                    mono)
                elif dtype == 1:
                    detail = self._vlc_header(payload, ctx, hit, s)
                elif dtype == 2:
                    detail = self._tlc(payload, ctx, hit, s)
                elif dtype == 6:
                    detail = self._data_header(payload, s)
                elif dtype == 7:
                    detail = self._r12_block(payload, s)
                elif dtype == 0:
                    detail = self._pi_header(payload, s)
                elif dtype == 11:
                    detail = self._usbd(payload)
        detail += self._take_slc()
        ctx.emit(head + detail, "dmr", pos, cc=cc, dtype=dtype, slot=s)

    def _take_slc(self) -> str:
        """Completed short-LC line from the last CACH, once."""
        line = self._slc_line
        self._slc_line = None
        return f"\n {line.strip()}" if line else ""

    def _usbd(self, bits96: np.ndarray) -> str:
        """Unified Single Block Data (dtype 0x0B, CRC16 mask 0x3333):
        4-bit service + 92-bit payload; service 0 is a LIP location
        (reference dmr_dburst.c dmr_dburst_handle_usbd)."""
        ccrc = crc.crc16_bits(bits96[:80], init=0, xorout=0xFFFF) ^ 0x3333
        if ccrc != _bits_to_int(bits96[80:96]):
            return " | USBD CRC16 ERR"
        service = _bits_to_int(bits96[0:4])
        names = {0: "Location Information Protocol"}
        name = names.get(service,
                         "Standard Service" if service <= 8 else
                         "Reserved (standard)" if service <= 15 else
                         "Manufacturer Specific")
        payload = "".join(
            f"[{_bits_to_int(bits96[4 + 8 * i:12 + 8 * i]):02X}]"
            for i in range(11)) + f"[{_bits_to_int(bits96[92:96]):X}]"
        out = f" | USBD - Service: {name} ({service}) - Payload: {payload}"
        if service == 0:
            from dsdneo_tpu_torch.protocol.dmr.gps import decode_lip
            out += "\n  " + decode_lip(bits96)
        return out

    def _mbc_continuation(self, bits96: np.ndarray, ctx: DecoderContext,
                          hit, s: int, mono: bool) -> str:
        """MBC continuation: append to the slot's aggregate; the LB
        flag (bit 0) closes it — CRC-CCITT16 over the continuation
        payload gates the extended-CSBK decode, which exposes the
        absolute-frequency CDEF fields at bits 112+ to C_MOVE/C_BCAST
        (reference dmr_block.c MBC aggregation → dmr_cspdu)."""
        st = self.mbc.get(s)
        if st is None:
            return " | MBC Continuation (no header)"
        if len(st) >= 6:            # reference bounds the aggregate at
            self.mbc[s] = None      # six blocks (mbc_block_bits[12*8*6])
            return " | MBC aggregate overflow"
        st.append(bits96)
        if not bits96[0]:                     # not the last block yet
            return f" | MBC Continuation {len(st) - 1}"
        agg = np.concatenate(st)
        self.mbc[s] = None
        cont = agg[96:]
        ccrc = crc.crc16_bits(cont[:len(cont) - 16], init=0x0000,
                              xorout=0xFFFF)
        rcrc = _bits_to_int(cont[len(cont) - 16:])
        if ccrc != rcrc:
            return " | MBC CRC ERR"
        from dsdneo_tpu_torch.protocol.dmr.csbk import decode_csbk
        return " | MBC" + decode_csbk(agg, ctx, hit=hit, slot=s,
                                      ms_sync=mono)

    def _data_header(self, bits96: np.ndarray, slot: int) -> str:
        from dsdneo_tpu_torch.protocol.dmr.data import parse_data_header
        hdr = parse_data_header(bits96)
        if hdr is None:
            return " | Data Header CRC ERR"
        self.assembler[slot].start(hdr, header_bits=bits96)
        return " | " + hdr.describe()

    def _r12_block(self, bits96: np.ndarray, slot: int) -> str:
        """Rate-1/2 unconfirmed data block: the 96 BPTC bits are payload."""
        block = np.packbits(bits96)
        done = self.assembler[slot].add_block(block)
        return done if done else f" | block {self.assembler[slot].count}"

    def _r1_block(self, bits196: np.ndarray, slot: int) -> str:
        """Rate-1 (uncoded) data block: 24 payload octets straight off
        the burst (reference dmr_dburst.c databurst 0x0A, pdu_len 24)."""
        block = np.packbits(bits196[:192])
        done = self.assembler[slot].add_block(block)
        return done if done else f" | R1 block {self.assembler[slot].count}"

    def _r34_block(self, bits196: np.ndarray, slot: int) -> str:
        """Rate-3/4 data block (ETSI trellis; reference dmr_dburst.c
        dmr_dburst_handle_trellis)."""
        from dsdneo_tpu_torch.fec import trellis34
        dibits = ((bits196[0::2] << 1) | bits196[1::2]).astype(np.uint8)
        data18, metric = trellis34.decode_r34(dibits)
        done = self.assembler[slot].add_block(data18)
        tag = "" if metric == 0 else f" (metric {metric})"
        return done if done else f" | R34 block {self.assembler[slot].count}{tag}"

    def _pi_header(self, bits96: np.ndarray, slot: int = 0) -> str:
        """PI header (privacy indicator, CRC mask 0x6969); installs the
        slot's voice crypto (alg/key/MI, keystream drop 256)."""
        ccrc = crc.crc16_bits(bits96[:80], init=0, xorout=0xFFFF) ^ 0x6969
        if ccrc != _bits_to_int(bits96[80:96]):
            return " | PI Header CRC ERR"
        alg = _bits_to_int(bits96[0:8])
        kid = _bits_to_int(bits96[16:24])
        mi = _bits_to_int(bits96[24:56])
        self.crypto[slot].update(alg=alg, kid=kid, mi=mi, drop=256)
        return f" | PI H- ALG ID: {alg:02X}; KEY ID: {kid:02X}; MI(32): {mi:08X};"

    def _csbk(self, bits96: np.ndarray, ctx: DecoderContext,
              hit=None, slot: int = 0, mono: bool = False) -> str:
        """Control Signalling Block (TS 102 361-2/-4; CRC mask 0xA5A5);
        catalog in csbk.py (Tier III + Cap+/Con+ vendor sets)."""
        from dsdneo_tpu_torch.protocol.dmr.csbk import decode_csbk
        ccrc = crc.crc16_bits(bits96[:80], init=0, xorout=0xFFFF) ^ 0xA5A5
        rcrc = _bits_to_int(bits96[80:96])
        if ccrc != rcrc:
            return " | CSBK CRC ERR"
        return decode_csbk(bits96, ctx, hit=hit, slot=slot, ms_sync=mono)

    def _vlc_header(self, bits96: np.ndarray, ctx: DecoderContext,
                    hit: SyncHit = None, s: int = 0,
                    label: str = "VLC") -> str:
        """Voice LC header: 72-bit FLC + RS(12,9) (CRC mask 0x969696);
        the corrected FLC dispatches through the full FLCO catalog
        (service options, vendor branding, alias/GPS headers)."""
        from dsdneo_tpu_torch.fec import rs as rsmod
        code = rsmod.rs_12_9()
        syms = np.array([_bits_to_int(bits96[i * 8:(i + 1) * 8]) for i in range(12)],
                        dtype=np.int64)
        syms[9:12] ^= 0x96
        dec, nerr = code.decode(syms)
        if nerr < 0:
            return f" | {label} RS ERR"
        lc_bits = np.zeros(72, dtype=np.uint8)
        for i in range(9):
            for j in range(8):
                lc_bits[8 * i + j] = (int(dec[i]) >> (7 - j)) & 1
        flco = int(dec[0]) & 0x3F
        dst = (int(dec[3]) << 16) | (int(dec[4]) << 8) | int(dec[5])
        src = (int(dec[6]) << 16) | (int(dec[7]) << 8) | int(dec[8])
        if hit is not None:
            self._flco(lc_bits, s, ctx, hit, label)
        else:
            ctx.state.last_tg, ctx.state.last_src = dst, src
        kind = ("Group" if flco == 0
                else ("Private" if flco == 3 else f"FLCO {flco:02X}"))
        return f" | {label} {kind} TGT={dst} SRC={src}"

    def _tlc(self, bits96: np.ndarray, ctx: DecoderContext,
             hit: SyncHit = None, s: int = 0) -> str:
        """Terminator LC: same FLC body; a valid TLC ends the call
        (reference dmr_flco terminator path)."""
        out = self._vlc_header(bits96, ctx, hit, s, label="TLC")
        if hit is not None and "RS ERR" not in out:
            ctx.emit(f" Slot {s + 1} - Call End (TLC)", "dmr", hit.pos,
                     release=True)
        return out

    # -- voice bursts -----------------------------------------------------
    def _voice_burst(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext,
                     invert: bool, mono: bool = False) -> None:
        pos = hit.pos
        polarity = "-" if invert else "+"
        if mono:
            s = 0
            lights = ["MS/DM", "MODE/MONO"]
        else:
            slot = self._cach_slot(reader, pos, invert)
            s = slot if slot is not None else 0
            lights = ["[slot1]", " slot2 "] if s == 0 else [" slot1 ", "[slot2]"]
        cc = self.color_code if self.color_code >= 0 else ctx.state.dmr_color_code
        cc_str = f"{cc:02d}" if cc >= 0 else "XX"
        ctx.emit(f"Sync: {polarity}DMR {lights[0]} {lights[1]} "
                 f"| Color Code={cc_str} | VC1" + self._take_slc(),
                 "dmr", pos, slot=s)
        self._voice_payload(reader, pos, invert, s, ctx, vc=1)
        self._follow_superframe(reader, hit, ctx, invert, s, cc_str, lights,
                                polarity)

    def _voice_payload(self, reader: DibitReader, pos: int, invert: bool,
                       s: int, ctx: DecoderContext, vc: int = 1) -> None:
        """AMBE frames: 108 bits either side of the centre field."""
        h1 = self._slice_bits(reader, pos - 54, 54, invert)
        h2 = self._slice_bits(reader, pos + 24, 54, invert)
        if h1 is not None and h2 is not None:
            voice216 = np.concatenate([h1, h2])
            ctx.events[-1].fields["ambe216"] = voice216
            if not getattr(ctx.state, "dmr_le_disable", False):
                self._collect_late_entry(voice216, s, vc, ctx)
            self._synthesize(voice216, s, ctx)
            if vc == 6:
                self._alg_refresh(s, ctx)

    def _collect_late_entry(self, voice216: np.ndarray, s: int, vc: int,
                            ctx: DecoderContext) -> None:
        """Store this burst's three 4-bit C3 MI fragments; at VC6,
        Golay-verify the assembled MI (reference dmr_le.c
        dmr_late_entry_mi_fragment / dmr_late_entry_mi)."""
        from dsdneo_tpu_torch.protocol.dmr.ambe_frame import (
            deinterleave_ambe72)
        from dsdneo_tpu_torch.protocol.dmr.late_entry import late_entry_decode
        for k in range(3):
            fr = deinterleave_ambe72(voice216[72 * k:72 * (k + 1)])
            self.le_frags[s][vc % 7][k] = _bits_to_int(fr[3][0:4])
        if vc != 6:
            return
        mi, crc_ok, golay_ok = late_entry_decode(self.le_frags[s])
        if not golay_ok:
            return
        cs = self.crypto[s]
        if cs["alg"] and cs["mi"] != mi:
            ctx.emit(f" Slot {s + 1} PI/LFSR and Late Entry MI Mismatch"
                     f" - {cs['mi']:08X} : {mi:08X} "
                     + ("(CRC OK)" if crc_ok else "(CRC ERR)"),
                     "dmr", 0, slot=s)
            if crc_ok:
                cs["mi"] = mi
        elif not cs["alg"] and crc_ok:
            # no PI header seen: adopt the late-entry MI; infer RC4 when
            # a scalar key is loaded (reference
            # dmr_maybe_infer_algid_from_key)
            kr = getattr(ctx.state, "keyring", None)
            if kr is not None and (kr.scalar or kr.forced is not None):
                cs.update(alg=0x21, kid=0xFF, mi=mi, drop=256)
                ctx.emit(f" Slot {s + 1} DMR Late Entry MI: {mi:08X};"
                         " RC4 (inferred);", "dmr", 0, slot=s)

    def _alg_refresh(self, s: int, ctx: DecoderContext) -> None:
        """Per-superframe crypto refresh (reference
        dmr_alg_refresh_slot): RC4 advances the MI through the 32-bit
        LFSR and resets the keystream drop to 256."""
        from dsdneo_tpu_torch.protocol.dmr.late_entry import mi_advance32
        cs = self.crypto[s]
        if cs["alg"] == 0x21 and cs["mi"]:
            cs["mi"] = mi_advance32(cs["mi"])
            cs["drop"] = 256
            ctx.emit(f" Slot {s + 1} DMR PI C- ALG ID: {cs['alg']:02X};"
                     f" KEY ID: {cs['kid']:02X}; MI(32): {cs['mi']:08X};"
                     " RC4;", "dmr", 0, slot=s)

    def _follow_superframe(self, reader: DibitReader, hit: SyncHit,
                           ctx: DecoderContext, invert: bool, s: int,
                           cc_str: str, lights: list, polarity: str) -> None:
        """VC2-VC6 bursts carry no sync: the 48-bit centre field is
        EMB + a 32-bit embedded-LC fragment (reference dmr_bs.c
        read_dmr_bs_sync_segment, dmr_dburst_handle_emb).  Same-slot
        bursts repeat every 288 dibits."""
        frags = []
        for k in range(1, 6):
            base = hit.pos + 288 * k
            center = self._slice_bits(reader, base, 24, invert)
            if center is None:
                break
            # a strong sync correlation means a new burst, not EMB
            if self._looks_like_sync(reader, base):
                break
            emb16 = np.concatenate([center[0:8], center[40:48]])
            qr = blockcodes.qr_16_7_6()
            msg, errs = qr.decode(emb16)
            emb_ok = errs <= 1
            lcss = msg & 3
            if emb_ok:
                self.color_code = (msg >> 3) & 0xF
                cc_str = f"{self.color_code:02d}"
            ctx.emit(f"Sync: {polarity}DMR {lights[0]} {lights[1]} "
                     f"| Color Code={cc_str} | VC{k + 1}",
                     "dmr", base, slot=s)
            self._voice_payload(reader, base, invert, s, ctx, vc=k + 1)
            if k <= 4:
                frags.append(center[8:40])
        if len(frags) == 4:
            self._embedded_lc(np.concatenate(frags), s, ctx, hit)

    def _looks_like_sync(self, reader: DibitReader, base: int) -> bool:
        from dsdneo_tpu_torch.symbols import framesync
        if base + 24 > len(reader.dibits):
            return True
        seg = reader.soft[base:base + 24]
        for d in framesync.patterns_for({"dmr"}):
            ref = d.levels
            if len(ref) == 24 and float(np.dot(seg, ref)) / (24 * 9) > 0.82:
                return True
        return False

    def _embedded_lc(self, bits128: np.ndarray, s: int, ctx: DecoderContext,
                     hit: SyncHit) -> None:
        """4×32-bit fragments → BPTC 16×8 (column-major) → 7 rows of
        Hamming(16,11,4) + column parity → 72-bit FLC + 5-bit checksum
        (sum of 9 bytes mod 31).  Reference fec/bptc.c
        BPTC_128x77_Extract_Data, dmr_utils.c ComputeCrc5Bit."""
        mat = np.zeros((8, 16), dtype=np.uint8)
        k = 0
        for i in range(16):
            for j in range(8):
                mat[j][i] = bits128[k]
                k += 1
        ham = blockcodes.hamming_16_11_4()
        bad = 0
        for r in range(7):
            msg, errs = ham.decode(mat[r])
            if errs > 1:
                bad += 1
            mat[r][:11] = ham.codebook[msg][:11]
        data = np.zeros(77, dtype=np.uint8)
        k = 0
        for r in range(2):
            data[k:k + 11] = mat[r][:11]
            k += 11
        for r in range(2, 7):
            data[k:k + 10] = mat[r][:10]
            k += 10
        for r in range(2, 7):
            data[k] = mat[r][10]
            k += 1
        crc_rx = _bits_to_int(data[72:77])
        total = sum(int(_bits_to_int(data[8 * i:8 * i + 8])) for i in range(9))
        if total % 31 != crc_rx or bad:
            return
        self._flco(data[:72], s, ctx, hit, "Embedded LC")

    # -- full link control ------------------------------------------------
    def _flco(self, lc_bits: np.ndarray, s: int, ctx: DecoderContext,
              hit: SyncHit, label: str) -> None:
        """Full LC parse incl. talker alias + embedded GPS dispatch
        (reference dmr_flco.c)."""
        flco = _bits_to_int(lc_bits[2:8])
        fid = _bits_to_int(lc_bits[8:16])
        if flco == 0x00 or flco == 0x03:
            so = _bits_to_int(lc_bits[16:24])
            tgt = _bits_to_int(lc_bits[24:48])
            src = _bits_to_int(lc_bits[48:72])
            ctx.state.last_tg, ctx.state.last_src = tgt, src
            kind = "Group" if flco == 0 else "Private"
            # service options + vendor branding (reference dmr_flco.c
            # print_service_options / print_branding / emergency flag)
            opts_str = ""
            if so & 0x80:
                opts_str += " Emergency"
            if so & 0x40:
                opts_str += " Privacy"
            if fid == 0x10 and so & 0x20:
                opts_str += " TXI"
            if fid == 0x10 and so & 0x10:
                opts_str += " RPT"
            if so & 0x08:
                opts_str += " Broadcast"
            if so & 0x04:
                opts_str += " OVCM"
            if so & 0x03:
                opts_str += f" Priority {so & 0x03}"
            brand = {0x68: " Hytera", 0x10: " Cap+", 0x06: " Con+",
                     0x58: " Tait"}.get(fid, "")
            ctx.emit(f" Slot {s + 1} - {label} {kind}{brand} TGT={tgt}"
                     f" SRC={src} FID=0x{fid:02X}{opts_str}", "dmr",
                     hit.pos, tg=tgt, src=src,
                     emergency=bool(so & 0x80), encrypted=bool(so & 0x40))
        elif flco == 0x04:            # talker alias header
            fmt = _bits_to_int(lc_bits[16:18])
            ln = _bits_to_int(lc_bits[18:23])
            char_size = {0: 7, 1: 8, 2: 8}.get(fmt, 16)
            start = 23 if char_size == 7 else 24
            self.alias[s] = {"size": char_size, "len": ln,
                             "bits": {0: list(lc_bits[start:72])}}
            ctx.emit(f" Slot {s + 1} - Talker Alias LC Header; Format {fmt};"
                     f" Char Len: {ln}; Char Size: {char_size};"
                     f"{self._alias_text(s)}", "dmr", hit.pos)
        elif 0x05 <= flco <= 0x07:    # talker alias blocks 1-3
            blk = flco - 4
            st = self.alias.get(s)
            if st is None:
                ctx.emit(f" Slot {s + 1} - Talker Alias Block Num: {blk + 1};"
                         " Invalid Header;", "dmr", hit.pos)
                return
            st["bits"][blk] = list(lc_bits[16:72])
            ctx.emit(f" Slot {s + 1} - Talker Alias Block Num: {blk + 1};"
                     f" Valid Block;{self._alias_text(s)}", "dmr", hit.pos)
        elif flco == 0x08:            # embedded GPS
            from dsdneo_tpu_torch.protocol.dmr.gps import decode_embedded_gps
            line = decode_embedded_gps(lc_bits)
            ctx.emit(f" Slot {s + 1} - {line}", "dmr", hit.pos)
        else:
            ctx.emit(f" Slot {s + 1} - {label} FLCO=0x{flco:02X}"
                     f" FID=0x{fid:02X}", "dmr", hit.pos)

    def _alias_text(self, s: int) -> str:
        st = self.alias.get(s)
        if not st:
            return ""
        bits = []
        for blk in sorted(st["bits"]):
            bits.extend(st["bits"][blk])
        cs = st["size"]
        chars = []
        for i in range(0, len(bits) - cs + 1, cs):
            v = _bits_to_int(bits[i:i + cs])
            if cs == 16:
                if v == 0:
                    break
                chars.append(chr(v) if 32 <= v < 0xD800 else "?")
            else:
                if v == 0:
                    break
                chars.append(chr(v) if 32 <= v < 127 else "?")
            if st["len"] and len(chars) >= st["len"]:
                break
        text = "".join(chars).strip()
        return f" Talker Alias: {text}" if text else ""

    def _synthesize(self, voice216: np.ndarray, slot: int,
                    ctx: DecoderContext) -> None:
        from dsdneo_tpu_torch.protocol.dmr.ambe_frame import decode_ambe_ecc
        from dsdneo_tpu_torch.vocoder.mbe import decode_ambe_2450
        s_obj = ctx.state
        bp_id = int(getattr(s_obj, "dmr_bp_key_id", 0) or 0)
        bp_ks = None
        if 0 < bp_id < 256:
            from dsdneo_tpu_torch.crypto.keystream import dmr_basic_keystream
            bp_ks = dmr_basic_keystream(bp_id)
        csi_key = getattr(s_obj, "dmr_csi72_key", None)
        csi_ks = None
        if csi_key is not None:
            from dsdneo_tpu_torch.crypto.vendor import csi72_keystream72
            csi_ks = csi72_keystream72(csi_key)
        tyt16 = getattr(s_obj, "dmr_tyt16_key", None)
        retevis = getattr(s_obj, "dmr_retevis_rc2", None)
        tyt_ap = getattr(s_obj, "dmr_tyt_ap", None)
        baofeng = getattr(s_obj, "dmr_baofeng_pc5", None)
        tyt_ep = getattr(s_obj, "dmr_tyt_ep_key", None)
        tyt_ep_ks = None
        if tyt_ep is not None:
            from dsdneo_tpu_torch.crypto.vendor import tyt_ep_keystream49
            tyt_ep_ks = tyt_ep_keystream49(int(tyt_ep))
        # superframe-keystream vendors (reference crypt-etc.c
        # xor_keystream_bits_frame49 family: Hytera BP -H, Kenwood
        # scrambler -9, Anytone BP -A, straight mod-XOR -S)
        sf_ks = getattr(s_obj, "dmr_sf_keystream", None)
        if sf_ks is None:
            hyt = getattr(s_obj, "dmr_hytera_bp", None)
            ken = getattr(s_obj, "dmr_kenwood_key", None)
            anyt = getattr(s_obj, "dmr_anytone_key", None)
            if hyt is not None:
                from dsdneo_tpu_torch.crypto.vendor import hytera_bp_keystream
                sf_ks = s_obj.dmr_sf_keystream = hytera_bp_keystream(*hyt)
            elif ken is not None:
                from dsdneo_tpu_torch.crypto.vendor import (
                    kenwood_scrambler_keystream)
                sf_ks = s_obj.dmr_sf_keystream = \
                    kenwood_scrambler_keystream(int(ken))
            elif anyt is not None:
                from dsdneo_tpu_torch.crypto.vendor import anytone_bp_keystream
                bits16 = anytone_bp_keystream(int(anyt))
                sf_ks = s_obj.dmr_sf_keystream = \
                    bits16[np.arange(882) % 16]
        static_ks = getattr(s_obj, "dmr_static_ks", None)
        if static_ks is None:
            # Vertex per-key static keystream map (reference
            # dsd_import.c vertex_ks_parse_row: key_hex,keystream_spec
            # rows; the slot's announced KEY ID selects the entry)
            vmap = getattr(s_obj, "dmr_vertex_ks_map", None)
            if vmap:
                static_ks = vmap.get(self.crypto[slot]["kid"])
        fcount = getattr(s_obj, "dmr_vc_frame_count", 0)
        params = []
        for k in range(3):
            fr72 = voice216[72 * k:72 * (k + 1)]
            if csi_ks is not None:       # on-air codeword-frame XOR
                fr72 = fr72 ^ csi_ks
            if tyt16 is not None:
                from dsdneo_tpu_torch.crypto.vendor import tyt16_keystream72
                fr72 = fr72 ^ tyt16_keystream72(int(tyt16), fcount + k)
            bits49, _errs = decode_ambe_ecc(fr72)
            bits49 = self._decrypt_rc4(bits49, slot, ctx)
            if sf_ks is not None:
                from dsdneo_tpu_torch.crypto.vendor import (
                    hytera_bp_apply_frame49)
                bits49 = hytera_bp_apply_frame49(sf_ks, (fcount + k) % 18,
                                                 bits49)
            if static_ks is not None:
                bits49 = static_ks.apply_frame49(bits49, slot)
            if bp_ks is not None:
                bits49 = bits49 ^ bp_ks          # bit 48 untouched (ks=0)
            if tyt_ep_ks is not None:
                bits49 = bits49 ^ tyt_ep_ks
            if retevis is not None:
                bits49 = retevis.decrypt_frame49(bits49)
            if tyt_ap is not None:
                bits49 = tyt_ap.decrypt_frame49(bits49)
            if baofeng is not None:
                bits49 = baofeng.decrypt_frame49(bits49)
            sink = getattr(ctx, "mbe_sink", None)
            if sink is not None:
                sink.write(bits49, _errs)
            if getattr(s_obj, "payload_log", False):
                # -Z console payload logging (reference opts->payload)
                hx = np.packbits(bits49.astype(np.uint8)).tobytes().hex()
                ctx.emit(f" AMBE {hx.upper()} err {_errs}", "dmr", 0,
                         slot=slot)
            params.append((bits49, _errs))
        s_obj.dmr_vc_frame_count = fcount + 3
        # MBE glue contract (vocoder.glue): tone frames synthesize the
        # OP25 tone, over-threshold frames repeat-then-mute
        from dsdneo_tpu_torch.vocoder.glue import (AMBE_ERR_THRESHOLD, MbeGlue,
                                                   ambe_tone_info)
        glues = getattr(s_obj, "ambe_glue", None)
        if glues is None:
            glues = s_obj.ambe_glue = {0: MbeGlue(AMBE_ERR_THRESHOLD),
                                       1: MbeGlue(AMBE_ERR_THRESHOLD)}
        glue = glues[slot]
        directives = []
        for bits49, errs in params:
            tone = ambe_tone_info(bits49)
            if tone is not None:
                directives.append(glue.condition(None, errs, tone))
            else:
                directives.append(glue.condition(decode_ambe_2450(bits49),
                                                 errs, None))
        pcm = glue.render(directives, ctx.device)
        # encrypted-without-key audio is muted (reference
        # dmr_mute_encL/R default 1); -q reverse mute flips the gate
        cs = self.crypto[slot]
        have_vendor = any(x is not None for x in
                          (csi_ks, tyt16, retevis, tyt_ap, baofeng,
                           tyt_ep_ks, sf_ks, static_ks, bp_ks))
        enc_mute = cs["alg"] not in (0, 0x80) \
            and not cs.get("key_ok") and not have_vendor
        mute = enc_mute ^ bool(getattr(s_obj, "reverse_mute", False))
        if pcm.size and not mute:
            ctx.emit_audio(pcm, slot=slot)

    def _decrypt_rc4(self, bits49: np.ndarray, slot: int,
                     ctx: DecoderContext) -> np.ndarray:
        """DMR RC4 (ALG 0x21) voice decrypt: rckey = 5-byte key ‖ 4-byte
        MI, 7 keystream octets per frame at the rolling slot drop
        (reference dsd_mbe.c mbeslot_left/right_apply_rc4)."""
        cs = self.crypto[slot]
        if cs["alg"] != 0x21 or not cs["mi"]:
            return bits49
        kr = getattr(ctx.state, "keyring", None)
        key = None
        if kr is not None:
            key = kr.lookup(cs["kid"])
            if key is None and len(kr.scalar) == 1:
                key = next(iter(kr.scalar.values()))   # single-key -R case
        if key is None:
            return bits49
        cs["key_ok"] = True
        from dsdneo_tpu_torch.crypto.keystream import rc4_keystream
        rckey = (int(key) & 0xFFFFFFFFFF).to_bytes(5, "big") \
            + (cs["mi"] & 0xFFFFFFFF).to_bytes(4, "big")
        ks = rc4_keystream(rckey, 7, drop=cs["drop"])
        cs["drop"] += 7
        plain = np.packbits(bits49.astype(np.uint8)) ^ ks
        return np.unpackbits(plain)[:49]
