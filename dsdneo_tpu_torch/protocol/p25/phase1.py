"""P25 Phase 1 (C4FM/CQPSK) frame decoder.

Host-side protocol layer over the device dibit stream.  Structure
citations into the reference for parity checking:
  - NID read order / status skip: src/engine/dispatch/dispatch_p25p1.c:86-141
  - TSDU/TSBK: src/protocol/p25/phase1/p25p1_tsbk.c (trellis + CRC16)
  - LDU1 layout: src/protocol/p25/phase1/p25p1_ldu1.c:185-286
  - LCW formats: src/protocol/p25/p25_lcw.c

The port's own copy of ``dsdneo_tpu/protocol/p25/phase1.py`` (numpy
only), registered for ``p25p1``: the serial frame walk (NID, HDU, LDU1
and LDU2 with the host IMBE vocoder and the ADP / DES-OFB voice
decrypt, TDULC, TSDU, MPDU) and the TSBK catalog that the batched
control-channel monitor (``engine.ccbatch``) also parses its payloads
with.  Every branch of the decision logic is as it stands there, so a
frame gives the same event lines and fields in both packages.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import blockcodes, crc, rs, trellis
from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                      ProtocolDecoder, register)
from dsdneo_tpu_torch.symbols.framesync import SyncHit

DUID_NAMES = {0x0: "HDU", 0x3: "TDU", 0x5: "LDU1", 0x7: "TSDU",
              0xA: "LDU2", 0xC: "PDU", 0xF: "TDULC"}


def _bits_to_int(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


@register("p25p1")
class P25P1Decoder(ProtocolDecoder):
    protocol = "p25p1"

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        reader.strip_status = True
        nid = self._read_nid(reader, ctx)
        if nid is None:
            return reader.pos
        nac, duid = nid
        s = ctx.state
        if nac not in (0, 0xFFF):
            s.nac = nac
            s.p2_cc = nac
        name = DUID_NAMES.get(duid, f"DUID {duid:X}")
        header = f"Sync: {hit.sync.name} | {ctx.frame_info()}{name}"
        ctx.emit(header, "p25p1", hit.pos, nac=nac, duid=duid)

        if duid == 0x7:
            self._tsdu(reader, hit, ctx)
        elif duid == 0x5:
            self._ldu1(reader, hit, ctx)
        elif duid == 0xA:
            self._ldu2(reader, hit, ctx)
        elif duid == 0x0:
            self._hdu(reader, hit, ctx)
        elif duid == 0xF:
            self._tdulc(reader, hit, ctx)
        elif duid == 0xC:
            self._mpdu(reader, hit, ctx)
        elif duid == 0x3:
            pass  # terminator: nothing further to read before next sync
        self._classify_status(reader, ctx)
        return reader.pos

    @staticmethod
    def _classify_status(reader: DibitReader, ctx: DecoderContext) -> None:
        """Classify the frame's transmission direction from the stripped
        status dibits (reference p25_status_symbol.c, sdrtrunk
        semantics: 01/11 count repeater/outbound, 00 counts subscriber,
        10 is ignored) — drives the advisory auto-PPM AFC gate
        (DSD_NEO_P25_AFC_STATUS_GATE)."""
        rep = sub = 0
        for d in reader.status_dibits:
            if d in (0x1, 0x3):
                rep += 1
            elif d == 0x0:
                sub += 1
        if rep > sub:
            cls = "infrastructure"
        elif sub > 0:
            cls = "subscriber"
        else:
            cls = "unknown"
        ctx.state.p25_ss_classification = cls

    # -- MPDU (packet data unit) ------------------------------------------
    # reference p25p1_pdu_data.c p25_sap_label (decimal SAPs)
    _SAP_NAMES = {0: "User Data", 1: "Encrypted User Data",
                  2: "Circuit Data", 3: "Circuit Data Control",
                  4: "Packet Data", 5: "Address Resolution Protocol",
                  6: "SNDCP Packet Data Control",
                  15: "Packet Data Scan Preamble",
                  29: "Packet Data Encryption Support",
                  31: "Extended Address",
                  32: "Registration and Authorization",
                  33: "Channel Reassignment", 34: "System Configuration",
                  35: "Mobile Radio Loopback",
                  36: "Mobile Radio Statistics",
                  37: "Mobile Radio Out of Service",
                  38: "Mobile Radio Paging",
                  39: "Mobile Radio Configuration",
                  40: "Unencrypted Key Management",
                  41: "Encrypted Key Management",
                  48: "Location Service",
                  61: "Trunking Control",
                  63: "Encrypted Trunking Control"}

    def _mpdu(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> None:
        """Multi-block PDU: header + blocks, each a 1/2-rate trellis
        codeword (reference p25p1_mdpu.c processMPDU; header fields
        p25p1_pdu_data.c p25_read_pdu_header_fields)."""
        hdr = self._mpdu_block(reader, crc_gate=True)
        if hdr is None:
            return
        if crc.crc16_bits(hdr[:80], init=0, xorout=0xFFFF) != _bits_to_int(hdr[80:96]):
            ctx.emit(" P25 Data Header CRC Error", "p25p1", hit.pos)
            return
        b = np.packbits(hdr[:96]).astype(np.int64)
        an = (int(b[0]) >> 6) & 1
        io = (int(b[0]) >> 5) & 1
        fmt = int(b[0]) & 0x1F
        sap = int(b[1]) & 0x3F
        mfid = int(b[2])
        address = (int(b[3]) << 16) | (int(b[4]) << 8) | int(b[5])
        blks = int(b[6]) & 0x7F
        pad = int(b[7]) & 0x1F
        line = f" P25 Data - AN: {an}; IO: {io}; FMT: {fmt:02X}; "
        sap_s = self._SAP_NAMES.get(sap, "Reserved")
        line += (f"\n F: {(int(b[6]) >> 7) & 1}; Blocks: {blks:02X};"
                 f" Pad: {pad}; MFID: {mfid:02X}; SAP: {sap:02X} [{sap_s}];")
        line += f" {'DST' if io else 'SRC'} LLID: {address};"
        ctx.emit(line, "p25p1", hit.pos, sap=sap, blocks=blks)
        data = []
        raw_blocks = []
        for _ in range(min(blks, 32)):
            blk = self._mpdu_block(reader)
            if blk is None:
                break
            data.append(np.packbits(blk[:96]))
            raw_blocks.append(blk)
        if sap in (61, 63) and raw_blocks:   # decimal (p25_sap_is_trunking_control)
            if fmt in (0x15, 0x17):
                # AMBTC/UMBTC: native multi-block trunking layouts
                # (p25p1_pdu_trunking.c); fall back to the TSBK bridge
                # for layouts that coincide with the single-block form
                from dsdneo_tpu_torch.protocol.p25.mbt import decode_mbt
                mpdu = np.concatenate([b[:12].astype(np.int64)]
                                      + [d.astype(np.int64) for d in data])
                if not decode_mbt(mpdu, ctx, hit, self):
                    for blk in raw_blocks:
                        self._tsbk(blk, hit, ctx)
            else:
                for blk in raw_blocks:
                    self._tsbk(blk, hit, ctx)
        if data and sap not in (61, 63):
            payload = np.concatenate(data)
            d = self._mpdu_data_sap(sap, payload, b, io, pad, ctx, hit)
            if d is None:
                hexs = "".join(f"{int(x):02X}" for x in payload[:24])
                d = f" P25 PDU Payload ({len(payload)} bytes) {hexs}"
            ctx.emit(d, "p25p1", hit.pos, payload=payload)

    def _mpdu_data_sap(self, sap: int, payload: np.ndarray, b: np.ndarray,
                       io: int, pad: int, ctx: DecoderContext,
                       hit: SyncHit) -> str | None:
        """Data-SAP routing on completed clear PDUs (reference
        p25_decode_clear_pdu_payload p25p1_pdu_data.c:988-1006:
        0 = IPv4, 4 = SNDCP packet data + IPv4, 6 = SNDCP control,
        32 = RegAuth, 34 = SysCfg, 48 = location/NMEA)."""
        off = int(b[9]) & 0x3F
        plen = max(0, len(payload) - 4 - pad)   # strip CRC32 + pad
        body = payload[off:plen]
        if len(body) == 0:
            return None
        if sap in (0x00, 0x04):
            from dsdneo_tpu_torch.protocol.dmr.ip_pdu import decode_ip_pdu
            pre = ""
            if sap == 0x04 and off == 2 and len(payload) >= 2:
                # SNDCP packet header nibbles ahead of the IP datagram
                typ, nsapi = int(payload[0]) >> 4, int(payload[0]) & 0xF
                pre = (f" SNDCP Packet Header"
                       f" {self._sndcp_type(typ, io == 1)}"
                       f" NSAPI:{nsapi} IPComp:{int(payload[1]) >> 4}"
                       f" UDPComp:{int(payload[1]) & 0xF};")
            ip = decode_ip_pdu(body)
            return (pre + ip) if ip else (pre or None)
        if sap == 0x06:
            typ, nsapi = int(body[0]) >> 4, int(body[0]) & 0xF
            return f" SNDCP {self._sndcp_type(typ, io == 1)} NSAPI:{nsapi}"
        if sap == 0x20:
            return (f" RegAuth subtype:{int(body[0])}"
                    f" bytes:{len(body)}")
        if sap == 0x22:
            return (f" SysCfg subtype:{int(body[0])}"
                    f" b1:{int(body[1]) if len(body) > 1 else 0}"
                    f" b2:{int(body[2]) if len(body) > 2 else 0}"
                    f" bytes:{len(body)}")
        if sap == 0x30:
            return self._location_data(body)
        return None

    @staticmethod
    def _sndcp_type(typ: int, outbound: bool) -> str:
        """SNDCP message types (p25p1_pdu_data.c
        p25_sndcp_type_label)."""
        if outbound:
            return {0: "Activate TDS Context Accept",
                    1: "Deactivate TDS Context Accept",
                    2: "Deactivate TDS Context Request",
                    3: "Activate TDS Context Reject",
                    4: "RF Unconfirmed Data",
                    5: "RF Confirmed Data"}.get(typ, "Outbound Unknown")
        return {0: "Activate TDS Context Request",
                1: "Deactivate TDS Context Accept",
                2: "Deactivate TDS Context Request",
                5: "RF Confirmed Data"}.get(typ, "Inbound Unknown")

    @staticmethod
    def _location_data(body: np.ndarray) -> str:
        """SAP 48 location: validated ASCII NMEA sentence, else
        best-effort UTF-8 text (reference
        p25_handle_sap48_location_data + nmea_sentence_checker)."""
        if int(body[0]) in (0x24, 0x21):        # '$' or '!'
            from dsdneo_tpu_torch.protocol.nmea import nmea_sentence_check
            return nmea_sentence_check(body)
        text = "".join(chr(int(v)) if 0x20 <= int(v) < 0x7F else " "
                       for v in body).strip()
        return f" Location Data Text: {text}" if text else " Location Data;"

    def _mpdu_block(self, reader: DibitReader,
                    crc_gate: bool = False) -> np.ndarray | None:
        if reader.remaining() < 98:
            return None
        bits, rel = reader.read_bits(98)
        llr = ((1 - 2 * bits.astype(np.int32))
               * np.clip(rel * 64, 1, 127)).astype(np.int32)
        if crc_gate:
            return self._trellis_crc_select(bits, llr)
        data96, _cost = trellis.p25_12_decode(bits, llr)
        return data96

    @staticmethod
    def _trellis_crc_select(bits: np.ndarray, llr: np.ndarray) -> np.ndarray:
        """Ranked-list trellis decode gated by the outer CRC16: try the
        candidates best-first and return the first that passes, else the
        best path (reference tsbk_select_crc_candidate, p25p1_tsbk.c:111
        over p25_12_soft_llr_list).

        The soft-decision knobs (docs/cli.md:500-505) shape the ranked
        retries: DSD_NEO_P25_SOFT_ERASURE_THRESHOLD (shared) /
        DSD_NEO_P25P1_SOFT_ERASURE_THRESHOLD (phase override) bound the
        list depth — lower is more conservative, higher expands — and
        DSD_NEO_P25_SOFT_HARD_OVERRIDE=0 keeps a CRC-passing hard
        Viterbi decode even when a soft candidate ranks better."""
        from dsdneo_tpu_torch.runtime import config as rtcfg
        cfg = rtcfg.get()
        thr = cfg.p25p1_soft_erasure_threshold or cfg.soft_erasure_threshold
        if not cfg.p25_soft_hard_override:
            data96, _cost = trellis.p25_12_decode(bits, llr)
            if crc.crc16_bits(data96[:80], init=0,
                              xorout=0xFFFF) == _bits_to_int(data96[80:96]):
                return data96
        depth = max(1, min(trellis.MAX_CANDIDATES, -(-int(thr) // 8)))
        cands = trellis.p25_12_decode_list(bits, llr, max_candidates=depth)
        for data96, _metric in cands:
            if crc.crc16_bits(data96[:80], init=0,
                              xorout=0xFFFF) == _bits_to_int(data96[80:96]):
                return data96
        if cands:
            return cands[0][0]
        data96, _cost = trellis.p25_12_decode(bits, llr)
        return data96

    # -- TDULC ------------------------------------------------------------
    def _tdulc(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> None:
        """Terminator with Link Control: 6 data + 6 parity dodeca words,
        each Golay(24,12), then RS(24,12,13) over the hexword pairs
        (reference p25p1_tdulc.c tdulc_read_data_and_parity_words /
        tdulc_build_lcw_payload)."""
        if reader.remaining() < 150:
            return
        gol = blockcodes.golay_24_12()
        words = np.zeros((12, 12), dtype=np.uint8)
        for w in range(12):
            bits, rel = reader.read_bits(12)
            msg, _e = gol.decode(bits, rel)
            words[w] = [(msg >> (11 - i)) & 1 for i in range(12)]
        # hexwords in plain stream order: word w yields hexwords 2w
        # (bits 0-5) and 2w+1 (bits 6-11); validated against the
        # p25p1_cqpsk_vc fixture's TDULC Group Voice LCWs
        hexwords = np.zeros(24, dtype=np.int64)
        for w in range(12):
            hexwords[2 * w] = _bits_to_int(words[w][0:6])
            hexwords[2 * w + 1] = _bits_to_int(words[w][6:12])
        code = rs.rs_24_12_13()
        dec, nerr = code.decode(hexwords)
        if nerr < 0:
            ctx.emit(" TDULC RS FEC ERR", "p25p1", hit.pos)
            return
        lc_bits = np.zeros(72, dtype=np.uint8)
        for i in range(12):
            for j in range(6):
                lc_bits[6 * i + j] = (int(dec[i]) >> (5 - j)) & 1
        self._lcw(lc_bits, hit, ctx)

    # -- NID --------------------------------------------------------------
    def _read_nid(self, reader: DibitReader, ctx: DecoderContext):
        """63-bit BCH(63,16) + parity bit; soft ML decode."""
        if reader.remaining() < 40:
            return None
        bits, rel = reader.read_bits(32)       # status dibit auto-stripped
        code, code_rel = bits[:63], rel[:63]
        bch = blockcodes.bch_63_16()
        msg, errs = bch.decode(code, code_rel)
        if errs > 16:                           # implausible decode: noise
            return None
        nac = msg >> 4
        duid = msg & 0xF
        return nac, duid

    # -- TSDU -------------------------------------------------------------
    def _tsdu(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> None:
        for _ in range(3):
            if reader.remaining() < 110:
                return
            bits, rel = reader.read_bits(98)
            llr = ((1 - 2 * bits.astype(np.int32)) * np.clip(rel * 64, 1, 127)).astype(np.int32)
            data96 = self._trellis_crc_select(bits, llr)
            if crc.crc16_bits(data96[:80], init=0, xorout=0xFFFF) != _bits_to_int(data96[80:96]):
                ctx.emit(" TSBK CRC ERR", "p25p1", hit.pos)
                return
            last = self._tsbk(data96, hit, ctx)
            if last:
                return

    @staticmethod
    def _iden_table(ctx: DecoderContext):
        from dsdneo_tpu_torch.engine.trunk import IdenTable
        if getattr(ctx.state, "iden_table", None) is None:
            ctx.state.iden_table = IdenTable()
        return ctx.state.iden_table

    def _chan_freq_note(self, ctx: DecoderContext, channel: int) -> str:
        """'P25 FREQ: map …' resolution line (reference
        p25_frequency.c process_channel_to_freq prints)."""
        freq = self._iden_table(ctx).channel_to_freq(channel)
        if freq is None:
            return ""
        return f"\n  P25 FREQ: map ch=0x{channel:04X} -> {freq / 1e6:.6f} MHz"

    def _iden_update(self, b: np.ndarray, opcode: int, ctx: DecoderContext,
                     hit: SyncHit) -> None:
        """IDEN_UP family (0x33 TDMA / 0x34 VHF-UHF / 0x3D standard);
        field extraction per reference p25p2_mac_parse.c
        p25p2_mac_decode_iden_* (the P1 TSBK bridges through the same
        layout, tsbk_build_mac_like_pdu)."""
        iden = int(b[2]) >> 4
        if opcode == 0x3D:               # standard
            bw = ((int(b[2]) & 0xF) << 5) | ((int(b[3]) & 0xF8) >> 3)
            sign = (int(b[3]) >> 2) & 1
            raw = ((int(b[3]) & 3) << 6) | (int(b[4]) >> 2)
            chan_type, bw_vu = 1, 0
            title = " Identifier Update (8.3.1.23)"
        else:                            # VHF/UHF and TDMA share layout
            bw_vu = int(b[2]) & 0xF
            sign = (int(b[3]) >> 7) & 1
            raw = ((int(b[3]) & 0x7F) << 6) | (int(b[4]) >> 2)
            bw = 0
            chan_type = bw_vu if opcode == 0x33 else 1
            title = (" Identifier Update for TDMA - Abbreviated"
                     if opcode == 0x33 else " Identifier Update UHF/VHF")
        trans_off = raw if sign else -raw
        chan_spac = ((int(b[4]) & 3) << 8) | int(b[5])
        base = (int(b[6]) << 24) | (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
        slots = {3: 2, 4: 4, 5: 2}.get(chan_type, 1) if opcode == 0x33 else 1
        self._iden_table(ctx).add(iden, base * 5.0, chan_spac * 125.0,
                                  trans_off * 250e3, slots)
        if opcode == 0x33:
            detail = (f"{title}\n  Channel Identifier [{iden:X}] Channel Type"
                      f" [{chan_type:X}] Transmit Offset [{trans_off & 0xFFFFFFFF:04X}]")
        elif opcode == 0x34:
            detail = (f"{title}\n  Channel Identifier [{iden:X}] BW [{bw_vu:X}]"
                      f" Transmit Offset [{trans_off & 0xFFFFFFFF:04X}]")
        else:
            detail = (f"{title}\n  Channel Identifier [{iden:X}] BW [{bw:X}]"
                      f" Transmit Offset [{trans_off & 0xFFFFFFFF:04X}]")
        detail += (f"\n  Channel Spacing [{chan_spac:03X}]"
                   f" Base Frequency [{base:08X}] [{base * 5:09d}]")
        ctx.emit(detail, "p25p1", hit.pos, iden=iden)

    def _tsbk_isp(self, opcode: int, b: np.ndarray, hit: SyncHit,
                  ctx: DecoderContext) -> None:
        """Inbound (subscriber→system) TSBK set (reference
        tsbk_handle_isp_messages p25p1_tsbk.c:917-944 and the four
        tsbk_handle_isp_* groups :764-908; field helpers: src=u24@7,
        tgt=u24@4, group=u16@5, WACN=b3<<12|b4<<4|b5>>4
        tsbk_wacn_from_24 :714-717, SYSID=(b5&0xF)<<8|b6
        tsbk_sys_from_44 :719-723)."""
        def u16(i):
            return (int(b[i]) << 8) | int(b[i + 1])

        def u24(i):
            return (int(b[i]) << 16) | (int(b[i + 1]) << 8) | int(b[i + 2])

        src = u24(7)
        tgt = u24(4)
        wacn = (int(b[3]) << 12) | (int(b[4]) << 4) | (int(b[5]) >> 4)
        sysid = ((int(b[5]) & 0xF) << 8) | int(b[6])
        b2, b3 = int(b[2]), int(b[3])
        sx = " (ISP protected/inbound)"
        # src_tgt-form labels with optional SVC / SVC+RESPONSE tails
        SRC_TGT = {0x04: ("Unit-to-Unit Voice Service Request", "svc"),
                   0x05: ("Unit-to-Unit Answer Response", "svc_rsp"),
                   0x08: ("Telephone Interconnect Explicit Dial Request",
                          "svc"),
                   0x09: ("Telephone Interconnect PSTN Request", "svc"),
                   0x0A: ("Telephone Interconnect Answer Response",
                          "svc_rsp"),
                   0x10: ("Individual Data Service Request", "svc"),
                   0x1F: ("Call Alert Request", ""),
                   0x2E: ("Authentication Query (obsolete)", ""),
                   0x2F: ("Authentication Response (obsolete)", ""),
                   0x36: ("Roaming Address Request", "")}
        WACN_SYS = {0x2B: "Unit De-Registration Request",
                    0x2C: "Unit Registration Request",
                    0x30: "Protection Parameter Request",
                    0x32: "Identifier/Frequency Band Update Request",
                    0x37: "Roaming Address Response"}
        STATUS = {0x18: ("Status Update Request", True),
                  0x19: ("Status Query Response", True),
                  0x1A: ("Status Query Request", False)}
        if opcode in (0x00, 0x11):
            label = ("Group Voice Service Request" if opcode == 0x00
                     else "Group Data Service Request")
            g = u16(5)
            ctx.emit(f" {label}{sx} FM [{src}] Group [{g}][{g:04X}]"
                     f" SVC [{b2:02X}]", "p25p1", hit.pos)
        elif opcode in SRC_TGT:
            label, tail = SRC_TGT[opcode]
            line = f" {label}{sx} FM [{src}] TO [{tgt}]"
            if tail:
                line += f" SVC [{b2:02X}]"
                if tail == "svc_rsp":
                    line += f" RESPONSE [{b3:02X}]"
            ctx.emit(line, "p25p1", hit.pos)
        elif opcode in WACN_SYS:
            line = (f" {WACN_SYS[opcode]}{sx} FM [{src}]"
                    f" WACN [{wacn:05X}] SYSID [{sysid:03X}]")
            if opcode == 0x2C:
                line += (f" EMERGENCY [{(b2 >> 7) & 1}]"
                         f" CAPABILITY [{b2 & 0x7F:02X}]")
            elif opcode == 0x37:
                line += f" MSN [{b2 & 0xF}] FINAL [{(b2 >> 7) & 1}]"
            ctx.emit(line, "p25p1", hit.pos)
        elif opcode in STATUS:
            label, has_status = STATUS[opcode]
            line = f" {label}{sx} FM [{src}] TO [{tgt}]"
            if has_status:
                line += (f" UNIT STATUS [{b2:02X}]"
                         f" USER STATUS [{b3:02X}]")
            ctx.emit(line, "p25p1", hit.pos)
        elif opcode == 0x12:
            ctx.emit(f" SNDCP Data Channel Request{sx} FM [{src}]"
                     f" DSO [{b2:02X}] DAC [{u16(3):04X}]",
                     "p25p1", hit.pos)
        elif opcode == 0x13:
            ctx.emit(f" SNDCP Data Page Response{sx} FM [{src}]"
                     f" DSO [{b2:02X}] RESPONSE [{b3:02X}]"
                     f" DAC [{u16(4):04X}]", "p25p1", hit.pos)
        elif opcode == 0x14:
            ctx.emit(f" SNDCP Reconnect Request{sx} FM [{src}]"
                     f" DSO [{b2:02X}] DAC [{u16(3):04X}]"
                     f" DATA_TO_SEND [{(int(b[5]) >> 7) & 1}]",
                     "p25p1", hit.pos)
        elif opcode == 0x1C:
            ctx.emit(f" Message Update Request{sx} FM [{src}] TO [{tgt}]"
                     f" SHORT DATA [{u16(2):04X}]", "p25p1", hit.pos)
        elif opcode == 0x20:
            ctx.emit(f" Unit Acknowledge Response{sx} FM [{src}]"
                     f" TO [{tgt}] ACK SVC [{b2 & 0x3F:02X}]",
                     "p25p1", hit.pos)
        elif opcode == 0x23:
            ctx.emit(f" Cancel Service Request{sx} FM [{src}]"
                     f" VALID [{(b2 >> 7) & 1}] SVC [{b2 & 0x3F:02X}]"
                     f" REASON [{b3:02X}] INFO [{u24(4):06X}]",
                     "p25p1", hit.pos)
        elif opcode == 0x24:
            ctx.emit(f" Extended Function Response{sx} FM [{src}]"
                     f" FUNC [{u16(2):04X}] ARG [{u24(4):06X}]",
                     "p25p1", hit.pos)
        elif opcode == 0x27:
            g = u16(5)
            ctx.emit(f" Emergency Alarm Request{sx} Source [{src}]"
                     f" Group [{g}][{g:04X}] ** EMERGENCY **",
                     "p25p1", hit.pos)
        elif opcode == 0x28:
            g = u16(5)
            ctx.emit(f" Group Affiliation Request{sx} FM [{src}]"
                     f" SYSID [{((b3 & 0xF) << 8) | int(b[4]):03X}]"
                     f" Group [{g}][{g:04X}]", "p25p1", hit.pos)
        elif opcode == 0x29:
            ag, g = u16(3), u16(5)
            ctx.emit(f" Group Affiliation Query Response{sx} FM [{src}]"
                     f" Announcement Group [{ag}][{ag:04X}]"
                     f" Group [{g}][{g:04X}]", "p25p1", hit.pos)
        elif opcode == 0x2D:
            g = u16(5)
            ctx.emit(f" Location Registration Request{sx} FM [{src}]"
                     f" EMERGENCY [{(b2 >> 7) & 1}]"
                     f" CAPABILITY [{b2 & 0x7F:02X}] LRA [{int(b[4]):02X}]"
                     f" Group [{g}][{g:04X}]", "p25p1", hit.pos)
        elif opcode in (0x38, 0x39, 0x3A, 0x3B):
            data = "".join(f"{int(b[i]):02X}" for i in range(2, 10))
            ctx.emit(f" Authentication Message{sx} OP [{opcode:02X}]"
                     f" SRC [{src}] DATA [{data}]", "p25p1", hit.pos)
        else:
            data = "".join(f"{int(b[i]):02X}" for i in range(2, 10))
            ctx.emit(f" Unsupported ISP opcode (protected/inbound)"
                     f" OP [{opcode:02X}] DATA [{data}]", "p25p1", hit.pos)

    def _tsbk_isp_mfid90(self, opcode: int, b: np.ndarray, hit: SyncHit,
                         ctx: DecoderContext) -> None:
        """Protected MFID90 TSBKs are Motorola inbound requests
        (reference tsbk_handle_mfid90_isp_messages
        p25p1_tsbk.c:946-975)."""
        src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
        if opcode == 0x00:
            sg = (int(b[5]) << 8) | int(b[6])
            ctx.emit(" MFID90 (Moto) Group Regroup Voice Request"
                     f" (ISP protected/inbound) FM [{src}]"
                     f" SG [{sg}][{sg:04X}] SVC [{int(b[2]):02X}]",
                     "p25p1", hit.pos)
        elif opcode == 0x01:
            func = (int(b[2]) << 8) | int(b[3])
            arg = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            ctx.emit(" MFID90 (Moto) Extended Function Response"
                     f" (ISP protected/inbound) FM [{src}]"
                     f" FUNC [{func:04X}] ARG [{arg:06X}]",
                     "p25p1", hit.pos)
        else:
            data = "".join(f"{int(b[i]):02X}" for i in range(2, 10))
            ctx.emit(" Unsupported MFID90 ISP opcode (protected/inbound)"
                     f" OP [{opcode:02X}] DATA [{data}]", "p25p1", hit.pos)

    def _queued_deny(self, b: np.ndarray, is_deny: bool, prefix: str,
                     hit: SyncHit, ctx: DecoderContext) -> None:
        """Queued/Deny response (reference p25_response_reason.c tables;
        addl-info print gated on bit 7 of the service octet)."""
        from dsdneo_tpu_torch.protocol.p25.p2_mac import (_DENY_REASONS,
                                                    _QUEUED_REASONS)
        has_addl = bool(int(b[2]) & 0x80)
        svc = int(b[2]) & 0x3F
        reason = int(b[3])
        addl = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
        tgt = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
        reasons = _DENY_REASONS if is_deny else _QUEUED_REASONS
        line = (f"{prefix} {'Deny' if is_deny else 'Queued'} Response\n"
                f"  SVC [{svc:02X}]"
                f" Reason [{reasons.get(reason, f'{reason:02X}')}]")
        if has_addl:
            line += f" Addl [{addl:06X}]"
        line += f" Target [{tgt}]"
        ctx.emit(line, "p25p1", hit.pos, release=True, deny=is_deny)

    def _mfid90(self, b: np.ndarray, opcode: int, hit: SyncHit,
                ctx: DecoderContext) -> None:
        """Motorola (MFID 0x90) TSBKs (reference p25p1_tsbk.c:624-657)."""
        if opcode == 0x09:
            mk = (int(b[2]) >> 4) & 0xF
            ctx.emit(f" MFID90 (Moto) Scan Marker Broadcast\n"
                     f"  MK: {mk} MS: {int(b[3])} Value: {(int(b[4]) << 8) | int(b[5])}",
                     "p25p1", hit.pos)
        elif opcode == 0x0B:
            channel = (int(b[2]) << 8) | int(b[3])
            note = self._chan_freq_note(ctx, channel)
            ctx.emit(f" MFID90 (Moto) Control Channel Base Station ID\n"
                     f"  CHAN [{channel:04X}]{note}", "p25p1", hit.pos)
        elif opcode == 0x0A:
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" MFID90 (Moto) Emergency Alarm Activation\n"
                     f"  Source: {src} ** EMERGENCY **", "p25p1", hit.pos)
        elif opcode == 0x08:
            src = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            tgt = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" MFID90 (Moto) Acknowledge Response\n"
                     f"  Service [{int(b[2]) & 0x3F:02X}] Source [{src}] Target [{tgt}]",
                     "p25p1", hit.pos)
        elif opcode in (0x00, 0x01):
            # Group Regroup Add/Delete: SG + up to three WGIDs feed the
            # patch registry (reference tsbk_handle_mfid90_regroup_add_del)
            from dsdneo_tpu_torch.core.affiliation import table_for
            sg = (int(b[2]) << 8) | int(b[3])
            gas = [(int(b[4]) << 8) | int(b[5]),
                   (int(b[6]) << 8) | int(b[7]),
                   (int(b[8]) << 8) | int(b[9])]
            act = "Add" if opcode == 0x00 else "Delete"
            line = f" MFID90 (Moto) Group Regroup {act} Command\n  SG: {sg}"
            for i, ga in enumerate(gas):
                if ga:
                    line += f" GA{i + 1}: {ga}"
                    if opcode == 0x00:
                        table_for(ctx).patch_add_wgid(sg, ga)
                    else:
                        table_for(ctx).patch_remove_wgid(sg, ga)
            ctx.emit(line, "p25p1", hit.pos)
        elif opcode == 0x02:
            # Group Regroup Channel Grant (reference
            # tsbk_handle_mfid90_grant: svc@2, chan@3-4, sg@5-6, src@7-9)
            svc = int(b[2])
            channel = (int(b[3]) << 8) | int(b[4])
            sg = (int(b[5]) << 8) | int(b[6])
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" MFID90 (Moto) Group Regroup Channel Grant\n"
                     f"  SVC [{svc:02X}] CHAN [{channel:04X}] SG [{sg}]"
                     f" Source [{src}]{self._chan_freq_note(ctx, channel)}",
                     "p25p1", hit.pos, tg=sg, src=src, channel=channel,
                     svc=svc, grant=channel not in (0, 0xFFFF))
        elif opcode == 0x03:
            # Group Regroup Channel Grant Update: two chan/SG pairs
            ch1 = (int(b[2]) << 8) | int(b[3])
            sg1 = (int(b[4]) << 8) | int(b[5])
            ch2 = (int(b[6]) << 8) | int(b[7])
            sg2 = (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" MFID90 (Moto) Group Regroup Channel Grant Update\n"
                     f"  CH1 [{ch1:04X}] SG1 [{sg1}] CH2 [{ch2:04X}]"
                     f" SG2 [{sg2}]", "p25p1", hit.pos, tg=sg1, channel=ch1,
                     grant=ch1 not in (0, 0xFFFF))
        elif opcode == 0x04:
            # Extended Function: class/operand/arg/target + supergroup
            # create/cancel feeds the patch registry
            from dsdneo_tpu_torch.core.affiliation import table_for
            cls, operand = int(b[2]), int(b[3])
            arg = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            tgt = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            d = (f" MFID90 (Moto) Extended Function Command\n"
                 f"  Class [{cls:02X}] Operand [{operand:02X}]"
                 f" Arg [{arg:06X}] Target [{tgt}]")
            sg = arg & 0xFFFF
            if cls == 0x02 and operand == 0x00:
                d += " Create Supergroup"
                table_for(ctx).patch_update(sg)
                if tgt:
                    table_for(ctx).patch_add_wuid(sg, tgt)
            elif cls == 0x02 and operand == 0x01:
                d += " Cancel Supergroup"
                table_for(ctx).patch_clear(sg)
            ctx.emit(d, "p25p1", hit.pos)
        elif opcode == 0x05:
            msg = "".join(f"{int(b[k]):02X}" for k in range(2, 10))
            ctx.emit(f" MFID90 (Moto) Traffic Channel ID\n  MSG: {msg}",
                     "p25p1", hit.pos)
        elif opcode in (0x06, 0x07):
            self._queued_deny(b, opcode == 0x07, " MFID90 (Moto)", hit, ctx)
        elif opcode in (0x0E, 0x0F):
            label = ("Control Channel Planned Shutdown" if opcode == 0x0E
                     else "Opcode 15")
            data = "".join(f"{int(b[k]):02X}" for k in range(2, 10))
            ctx.emit(f" MFID90 (Moto) {label} [{data}]", "p25p1", hit.pos)
        elif opcode == 0x16:
            # reference tsbk_handle_mfid90_tdma_data_channel: downlink
            # @4-5, uplink @6-7 only
            chans = []
            for name, off in (("DL", 4), ("UL", 6)):
                ch = (int(b[off]) << 8) | int(b[off + 1])
                if ch not in (0, 0xFFFF):
                    chans.append(f"{name} [{ch:04X}]")
            ctx.emit(" MFID90 (Moto) TDMA Data Channel "
                     + (" ".join(chans) if chans else "Not Active"),
                     "p25p1", hit.pos)
        else:
            ctx.emit(f" MFID90 (Moto) Opcode {opcode:02X}", "p25p1", hit.pos)

    def _tsbk(self, bits96: np.ndarray, hit: SyncHit, ctx: DecoderContext) -> bool:
        """Parse one TSBK; returns True when the Last Block flag is set.
        Field layouts per TIA-102.AABC (reference p25p1_tsbk.c)."""
        b = np.packbits(bits96[:96]).astype(np.int64)   # 12 bytes
        lb = (b[0] >> 7) & 1
        protect = (b[0] >> 6) & 1
        opcode = int(b[0] & 0x3F)
        mfid = int(b[1])
        s = ctx.state
        if protect:
            # protected TSBKs decode as ISP (inbound/subscriber)
            # messages; the protect bit is checked BEFORE any MFID
            # routing (reference tsbk_dispatch_message protectbit path
            # p25p1_tsbk.c:1022-1029)
            if mfid < 2:
                self._tsbk_isp(opcode, b, hit, ctx)
            elif mfid == 0x90:
                self._tsbk_isp_mfid90(opcode, b, hit, ctx)
            else:
                ctx.emit(f" TSBK MFID {mfid:02X} OP {opcode:02X}"
                         " (protected)", "p25p1", hit.pos)
            return bool(lb)
        if mfid == 0x90:
            self._mfid90(b, opcode, hit, ctx)
            return bool(lb)
        if mfid == 0xA4 and opcode == 0x30:
            # Harris Group Regroup Explicit Encryption Command
            # (reference tsbk_handle_mfid_a4): TGA flags select WGID vs
            # WUID form; patch/simulselect + active state feed the
            # patch registry
            from dsdneo_tpu_torch.core.affiliation import table_for
            sg = (int(b[3]) << 8) | int(b[4])
            key = (int(b[5]) << 8) | int(b[6])
            tga = int(b[2]) >> 5
            ssn = int(b[2]) & 0x1F
            line = (f" MFID A4 (Harris) Group Regroup Explicit Encryption"
                    f" Command\n  SG: {sg}; KEY ID: {key:04X}; ")
            t = table_for(ctx)
            t.patch_update(sg, is_patch=not (tga & 0x4),
                           active=bool(tga & 0x1))
            if tga & 0x2:
                alg = int(b[7])
                wgid = (int(b[8]) << 8) | int(b[9])
                line += f"ALG: {alg:02X}; WGID: {wgid}; "
                if wgid:
                    t.patch_add_wgid(sg, wgid)
                t.patch_set_kas(sg, key, alg, ssn)
            else:
                wuid = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
                line += f"WUID: {wuid}; "
                if wuid:
                    t.patch_add_wuid(sg, wuid)
                t.patch_set_kas(sg, key, -1, ssn)
            line += (" Simulselect" if tga & 0x4 else " Patch")
            line += (" Active;" if tga & 0x1 else " Inactive;")
            line += f" SSN: {ssn:02d}"
            ctx.emit(line, "p25p1", hit.pos)
            return bool(lb)
        if mfid >= 2:
            ctx.emit(f" TSBK MFID {mfid:02X} OP {opcode:02X}", "p25p1", hit.pos)
            return bool(lb)
        if opcode == 0x3B:    # Network Status Broadcast
            wacn = (int(b[3]) << 12) | (int(b[4]) << 4) | (int(b[5]) >> 4)
            sysid = ((int(b[5]) & 0xF) << 8) | int(b[6])
            channel = (int(b[7]) << 8) | int(b[8])
            s.p2_wacn, s.p2_sysid = wacn, sysid
            ctx.emit(f" Network Status Broadcast TSBK - Abbreviated \n"
                     f"  LRA [{int(b[2]):02X}] WACN [{wacn:05X}] SYSID [{sysid:03X}]"
                     f" NAC [{s.p2_cc:03X}] CHAN-T [{channel:04X}]"
                     f"{self._chan_freq_note(ctx, channel)}",
                     "p25p1", hit.pos, wacn=wacn, sysid=sysid)
        elif opcode == 0x3A:  # RFSS Status Broadcast
            syid = ((int(b[3]) & 0xF) << 8) | int(b[4])
            rfss, site = int(b[5]), int(b[6])
            channel = (int(b[7]) << 8) | int(b[8])
            s.p2_rfssid, s.p2_siteid = rfss, site
            ctx.emit(f" RFSS Status Broadcast TSBK - Abbreviated \n"
                     f"  SYSID [{syid:03X}] RFSS [{rfss:03d}] SITE [{site:03d}]"
                     f" CHAN-T [{channel:04X}]"
                     f"{self._chan_freq_note(ctx, channel)}", "p25p1", hit.pos)
        elif opcode == 0x00:  # Group Voice Channel Grant
            # TIA layout (reference p25p2_vpdu.c MAC 0x40 / the shared
            # grant shape): svc@2, chan@3-4, group@5-6, src@7-9
            svc = int(b[2])
            channel = (int(b[3]) << 8) | int(b[4])
            group = (int(b[5]) << 8) | int(b[6])
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            s.last_tg, s.last_src = group, src
            ctx.emit(f" Group Voice Channel Grant\n"
                     f"  SVC [{svc:02X}] CHAN [{channel:04X}]"
                     f" TG [{group}] SRC [{src}]"
                     f"{self._chan_freq_note(ctx, channel)}",
                     "p25p1", hit.pos, tg=group, src=src, channel=channel,
                     grant=channel not in (0, 0xFFFF))
        elif opcode == 0x02:  # Group Voice Channel Grant Update
            ch1 = (int(b[2]) << 8) | int(b[3])
            g1 = (int(b[4]) << 8) | int(b[5])
            ch2 = (int(b[6]) << 8) | int(b[7])
            g2 = (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Group Voice Channel Grant Update"
                     f" CH1 [{ch1:04X}] TG1 [{g1}] CH2 [{ch2:04X}] TG2 [{g2}]",
                     "p25p1", hit.pos, tg=g1, channel=ch1)
        elif opcode in (0x04, 0x05):  # UU Voice Channel Grant / Answer Req
            channel = (int(b[2]) << 8) | int(b[3])
            tgt = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            name = ("Unit to Unit Voice Channel Grant" if opcode == 0x04
                    else "Unit to Unit Answer Request")
            ctx.emit(f" {name}\n  CHAN [{channel:04X}] Target [{tgt}] Source [{src}]"
                     f"{self._chan_freq_note(ctx, channel)}", "p25p1", hit.pos,
                     tg=tgt, src=src, channel=channel, private=True,
                     grant=(opcode == 0x04
                            and channel not in (0, 0xFFFF)))
        elif opcode in (0x33, 0x34, 0x3D):  # IDEN_UP family
            self._iden_update(b, opcode, ctx, hit)
        elif opcode == 0x39:  # Secondary CC Broadcast
            rfss, site = int(b[2]), int(b[3])
            ch1 = (int(b[4]) << 8) | int(b[5])
            ch2 = (int(b[7]) << 8) | int(b[8])
            ctx.emit(f" Secondary Control Channel Broadcast\n"
                     f"  RFSS [{rfss:03d}] SITE [{site:03d}] CHAN1 [{ch1:04X}]"
                     f" CHAN2 [{ch2:04X}]{self._chan_freq_note(ctx, ch1)}",
                     "p25p1", hit.pos)
        elif opcode == 0x3C:  # Adjacent Status Broadcast
            lra = int(b[2])
            cfva = int(b[3]) >> 4
            rfss, site = int(b[5]), int(b[6])
            channel = (int(b[7]) << 8) | int(b[8])
            ssc = int(b[9])
            flags = ""
            if cfva & 0x8:
                flags += " Conventional"
            if cfva & 0x4:
                flags += " Failure Condition"
            flags += " Up to Date (Correct)" if cfva & 0x2 else " Last Known"
            if cfva & 0x1:
                flags += " Valid RFSS Connection Active"
            ctx.emit(f" Adjacent Status Broadcast - Abbreviated\n"
                     f"  LRA [{lra:02X}] RFSS[{rfss:03d}] SITE [{site:03d}]"
                     f" SYSID [000] CHAN-T [{channel:04X}] SSC [{ssc:02X}]\n "
                     f" {flags.strip()}{self._chan_freq_note(ctx, channel)}",
                     "p25p1", hit.pos)
        elif opcode == 0x28:  # Group Affiliation Response
            gav = int(b[2]) & 0x3       # LG bit7, GAV bits 1-0
            aga = (int(b[3]) << 8) | int(b[4])
            ga = (int(b[5]) << 8) | int(b[6])
            tgt = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Group Affiliation Response\n  GAV [{gav}]"
                     f" Announce Group [{aga}] Group [{ga}] Target [{tgt}]",
                     "p25p1", hit.pos)
            if gav == 0:                # accepted only
                from dsdneo_tpu_torch.core.affiliation import table_for
                table_for(ctx).affiliate(tgt, ga)
        elif opcode == 0x2C:  # Unit Registration Response
            src = (int(b[6]) << 16) | (int(b[7]) << 8) | int(b[8])
            ctx.emit(f" Unit Registration Response\n  Source [{src}]",
                     "p25p1", hit.pos)
            from dsdneo_tpu_torch.core.affiliation import table_for
            table_for(ctx).register(src)
        elif opcode == 0x1F:  # Call Alert
            tgt = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Call Alert\n  Target [{tgt}] Source [{src}]",
                     "p25p1", hit.pos)
        elif opcode == 0x16:  # SNDCP Data Channel Announcement - Explicit
            ch1 = (int(b[2]) << 8) | int(b[3])
            ch2 = (int(b[4]) << 8) | int(b[5])
            ctx.emit(f" SNDCP (P1 TSBK) CH1 [{ch1:04X}] CH2 [{ch2:04X}]",
                     "p25p1", hit.pos)
        elif opcode == 0x30:  # Synchronization Broadcast
            ltoff = int(b[4]) & 0x3F
            year = int(b[5]) >> 1
            month = ((int(b[5]) & 1) << 3) | (int(b[6]) >> 5)
            day = int(b[6]) & 0x1F
            hour = int(b[7]) >> 3
            minute = ((int(b[7]) & 7) << 3) | (int(b[8]) >> 5)
            slots = ((int(b[8]) & 0x1F) << 8) | int(b[9])
            seconds = min(slots // 135, 59)
            offhour = ((ltoff & 0x1F) / 2.0) * (-1 if ltoff & 0x20 else 1)
            line = " Synchronization Broadcast"
            if year:
                line += (f"\n  Date: 20{year:02d}.{month:02d}.{day:02d}"
                         f" Time: {hour:02d}:{minute:02d}:{seconds:02d} UTC")
                if offhour:
                    line += f"\n  Local Time Offset: {offhour:.1f} Hours;"
            ctx.emit(line, "p25p1", hit.pos)
        elif opcode == 0x18:  # Status Update
            tgt = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Status Update\n  Target [{tgt}] Source [{src}]",
                     "p25p1", hit.pos)
        elif opcode == 0x1A:  # Status Query
            tgt = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Status Query\n  Target [{tgt}] Source [{src}]",
                     "p25p1", hit.pos)
        elif opcode == 0x1C:  # Message Update
            msg = (int(b[2]) << 8) | int(b[3])
            tgt = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Message Update\n  Target [{tgt}] Source [{src}]"
                     f" Message [{msg:04X}]", "p25p1", hit.pos)
        elif opcode == 0x20:  # Acknowledge Response - FNE
            svc = int(b[2]) & 0x3F
            src = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            tgt = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Acknowledge Response - FNE\n  Service [{svc:02X}]"
                     f" Target [{tgt}] Source [{src}]", "p25p1", hit.pos)
        elif opcode in (0x21, 0x27):  # Queued / Deny Response
            self._queued_deny(b, opcode == 0x27, "", hit, ctx)
        elif opcode == 0x24:  # Extended Function Command
            from dsdneo_tpu_torch.protocol.p25.p2_mac import _EXT_FUNC_CLASS0
            func = (int(b[2]) << 8) | int(b[3])
            cls, operand = (func >> 8) & 0xFF, func & 0xFF
            arg = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            tgt = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            d = (f" Extended Function Command\n  Class [{cls:02X}]"
                 f" Operand [{operand:02X}] Arg [{arg:06X}] Target [{tgt}]")
            if cls == 0 and operand in _EXT_FUNC_CLASS0:
                d += f" {_EXT_FUNC_CLASS0[operand]}"
            ctx.emit(d, "p25p1", hit.pos)
        elif opcode == 0x2A:  # Group Affiliation Query
            tgt = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
            src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Group Affiliation Query\n  Target [{tgt}]"
                     f" Source [{src}]", "p25p1", hit.pos)
        elif opcode in (0x08, 0x09):  # Telephone Interconnect Grant [Update]
            # reference layout (vpdu telephone grant, k=0 for TSBK):
            # svc@2, chan@3-4, timer@5-6, target@7-9
            svc = int(b[2])
            chan = (int(b[3]) << 8) | int(b[4])
            timer = (int(b[5]) << 8) | int(b[6])
            tgt = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Telephone Interconnect Voice Channel Grant"
                     f"{' Update' if opcode == 0x09 else ''}\n"
                     f"  SVC [{svc:02X}] CHAN [{chan:04X}]"
                     f" Timer [{timer / 10.0:.1f}s]"
                     f" Target [{tgt}]{self._chan_freq_note(ctx, chan)}",
                     "p25p1", hit.pos, channel=chan,
                     grant=chan not in (0, 0xFFFF))
        elif opcode == 0x03:  # Group Voice Channel Grant Update - Explicit
            svc = int(b[2])
            cht = (int(b[4]) << 8) | int(b[5])
            chr_ = (int(b[6]) << 8) | int(b[7])
            grp = (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Group Voice Channel Grant Update - Explicit\n"
                     f"  SVC [{svc:02X}] CHAN-T [{cht:04X}]"
                     f" CHAN-R [{chr_:04X}] Group [{grp}]"
                     f"{self._chan_freq_note(ctx, cht)}", "p25p1", hit.pos,
                     tg=grp, channel=cht, svc=svc,
                     grant=cht not in (0, 0xFFFF))
        elif opcode in (0x10, 0x11):  # Individual/Group Data Channel Grant
            if opcode == 0x10:
                chan = (int(b[2]) << 8) | int(b[3])
                tgt = (int(b[4]) << 16) | (int(b[5]) << 8) | int(b[6])
                src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
                d = (f" Individual Data Channel Grant - Obsolete\n"
                     f"  CHAN [{chan:04X}] Target [{tgt}] Source [{src}]")
            else:
                svc = int(b[2])
                chan = (int(b[3]) << 8) | int(b[4])
                grp = (int(b[5]) << 8) | int(b[6])
                src = (int(b[7]) << 16) | (int(b[8]) << 8) | int(b[9])
                d = (f" Group Data Channel Grant - Obsolete\n"
                     f"  SVC [{svc:02X}] CHAN [{chan:04X}] Group [{grp}]"
                     f" Source [{src}]")
            ctx.emit(d + self._chan_freq_note(ctx, chan), "p25p1", hit.pos,
                     channel=chan, data=True,
                     grant=chan not in (0, 0xFFFF))
        elif opcode == 0x12:  # Group Data Channel Announcement
            # chanA@2-3, grpA@4-5, chanB@6-7, grpB@8-9 (reference
            # tsbk_handle_group_data_channel_announcement)
            ch1 = (int(b[2]) << 8) | int(b[3])
            g1 = (int(b[4]) << 8) | int(b[5])
            ch2 = (int(b[6]) << 8) | int(b[7])
            g2 = (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Group Data Channel Announcement - Obsolete\n"
                     f"  CHAN-A [{ch1:04X}] Group-A [{g1}]"
                     f" CHAN-B [{ch2:04X}] Group-B [{g2}]",
                     "p25p1", hit.pos)
        elif opcode == 0x13:  # Group Data Channel Announcement - Explicit
            svc = int(b[2])
            cht = (int(b[4]) << 8) | int(b[5])
            chr_ = (int(b[6]) << 8) | int(b[7])
            grp = (int(b[8]) << 8) | int(b[9])
            ctx.emit(f" Group Data Channel Announcement - Explicit\n"
                     f"  SVC [{svc:02X}] CHAN-T [{cht:04X}]"
                     f" CHAN-R [{chr_:04X}] Group [{grp}]",
                     "p25p1", hit.pos)
        elif opcode == 0x35:  # Time and Date Announcement
            ctx.emit(" Time and Date Announcement", "p25p1", hit.pos)
        else:
            ctx.emit(f" TSBK OP [{opcode:02X}]", "p25p1", hit.pos)
        return bool(lb)

    # -- LDU1 -------------------------------------------------------------
    def _read_hexwords(self, reader: DibitReader, n: int):
        """Read n Hamming(10,6,3)-protected hexbits → (values, err flags)."""
        ham = blockcodes.hamming_10_6_3()
        vals = np.zeros(n, dtype=np.int64)
        errs = np.zeros(n, dtype=np.int64)
        for i in range(n):
            bits, rel = reader.read_bits(5)
            m, e = ham.decode(bits, rel)
            vals[i] = m
            errs[i] = e
        return vals, errs

    def _ldu1(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> None:
        if reader.remaining() < 820:
            return
        imbe = []
        hexwords = np.zeros(24, dtype=np.int64)
        hexerrs = np.zeros(24, dtype=np.int64)
        w = 0
        for seg in range(8):
            bits, _ = reader.read_bits(72)
            imbe.append(bits)
            if seg >= 1 and seg <= 6:
                vals, errs = self._read_hexwords(reader, 4)
                hexwords[w:w + 4] = vals
                hexerrs[w:w + 4] = errs
                w += 4
            elif seg == 7:
                reader.read(16)                    # LSD (2×(16,8) codewords)
        bits, _ = reader.read_bits(72)
        imbe.append(bits)

        code = rs.rs_24_12_13()
        word = hexwords.copy()
        eras = [int(i) for i in np.nonzero(hexerrs >= 2)[0]]
        dec, nerr = code.decode(word, erasures=eras)
        lc_bits = np.zeros(72, dtype=np.uint8)
        for i in range(12):
            for j in range(6):
                lc_bits[i * 6 + j] = (dec[i] >> (5 - j)) & 1
        if nerr < 0:
            ctx.emit(" LDU1 LC RS FEC ERR", "p25p1", hit.pos)
        else:
            self._lcw(lc_bits, hit, ctx)
        ctx.emit(" LDU1 VOICE (9 IMBE frames)", "p25p1", hit.pos,
                 imbe=np.stack(imbe))
        self._voice(imbe, ctx)

    def _voice(self, imbe_frames: list[np.ndarray], ctx: DecoderContext) -> None:
        """IMBE ECC (+ ADP/RC4 decrypt when keyed) + parameter decode +
        synthesis → 8 kHz PCM.

        Keystream discipline per the reference LDU layout: the two LSD
        octets sit between voice frames 8 and 9 and consume 2 keystream
        octets (p25p1_ldu1.c:185-186, p25p1_ldu2.c:207-208), so the
        rolling offset skips 2 before the 9th frame."""
        from dsdneo_tpu_torch.protocol.p25.imbe_frame import decode_imbe_ecc
        from dsdneo_tpu_torch.vocoder.glue import MbeGlue, imbe_tone_info
        from dsdneo_tpu_torch.vocoder.mbe import decode_imbe_4400
        glue = getattr(ctx.state, "imbe_glue", None)
        if glue is None:
            glue = ctx.state.imbe_glue = MbeGlue()
        prev = getattr(ctx.state, "imbe_prev", None)
        sink = getattr(ctx, "mbe_sink", None)
        directives = []
        for i, fr in enumerate(imbe_frames):
            bits88, errs = decode_imbe_ecc(fr)
            if i == 8:
                ctx.state.ks_offset = getattr(ctx.state, "ks_offset", 0) + 2
            bits88 = self._decrypt_imbe(bits88, ctx)
            if sink is not None:
                sink.write(bits88, errs)
            if getattr(ctx.state, "payload_log", False):
                # -Z console payload logging (reference opts->payload)
                hx = np.packbits(bits88.astype(np.uint8)).tobytes().hex()
                ctx.emit(f" IMBE {hx.upper()} err {errs}", "p25p1", 0)
            # the MBE glue contract (vocoder.glue, reference dsd_mbe.c /
            # mbelib process semantics): tone codes synthesize tones,
            # invalid non-voice codes and over-threshold frames repeat
            # the last good parameters a bounded number of times, then
            # mute
            from dsdneo_tpu_torch.vocoder.glue import imbe_raw_b0
            tone = imbe_tone_info(bits88)
            if tone is not None:
                directives.append(glue.condition(None, errs, tone))
                continue
            if imbe_raw_b0(bits88) > 207:
                # invalid non-voice code: process-failure path
                directives.append(glue.condition(
                    None, glue.err_threshold + 1 + errs, None))
                continue
            # full parameter decode only for frames that can use it
            frame = decode_imbe_4400(bits88, prev=prev)
            kind, arg = glue.condition(frame, errs, None)
            if kind == "voice":
                prev = frame
            directives.append((kind, arg))
        ctx.state.imbe_prev = prev
        pcm = glue.render(directives, ctx.device)
        # encrypted-without-key audio is muted (reference
        # unmute_encrypted_p25 default 0); -q reverse mute flips it
        mute = bool(getattr(ctx.state, "p25_enc_unbroken", False)) \
            ^ bool(getattr(ctx.state, "reverse_mute", False))
        if pcm.size and not mute:
            ctx.emit_audio(pcm, slot=0)
        if ctx.events:
            # per-call error accounting on the owning LDU event
            # (reference p25_p1_voice_err_hist rolling average)
            ctx.events[-1].fields.setdefault("voice_err_avg",
                                             round(glue.err_avg(), 2))

    def _decrypt_imbe(self, bits88: np.ndarray, ctx: DecoderContext) -> np.ndarray:
        """Keyed voice decrypt: ADP/RC4 (ALG 0xAA) or DES-OFB (0x81),
        XORing 11 keystream octets per voice frame at a rolling offset.

        Reference parity (dsd_mbe.c / p25p1_hdu.c:429 / p25p1_ldu2.c:238):
        the RC4 keystream position starts at absolute drop 267 per
        superframe; DES-OFB starts at octet 19 (8 discard + 8 LC + 3
        reserved).  Both advance 11 per frame and 2 extra across the LSD
        (handled by ``_voice``); the offset resets only after LDU2's own
        voice has been decrypted (ldu2_collect_voice_symbols)."""
        s = ctx.state
        kr = getattr(s, "keyring", None)
        algid = getattr(s, "payload_algid", 0)
        enc = algid not in (0, 0x80)
        s.p25_enc_unbroken = enc          # cleared below once a key applies
        if kr is None or algid not in (0xAA, 0x81):
            return bits88
        key = kr.lookup(getattr(s, "payload_kid", 0))
        mi = getattr(s, "payload_mi", 0)
        if key is None or mi == 0:
            return bits88
        s.p25_enc_unbroken = False
        off = getattr(s, "ks_offset", 0)
        if algid == 0xAA:
            from dsdneo_tpu_torch.crypto.keystream import p25_adp_keystream
            ks = p25_adp_keystream(key, mi, 11, drop=267 + off)
        else:
            from dsdneo_tpu_torch.crypto.keystream import des_ofb_keystream
            mi64 = (mi >> 8) & ((1 << 64) - 1)
            start = 19 + off
            ks = des_ofb_keystream(key, mi64, start + 11)[start:start + 11]
        s.ks_offset = off + 11
        ks_bits = np.unpackbits(np.asarray(ks, dtype=np.uint8))
        return (np.asarray(bits88, dtype=np.uint8) ^ ks_bits[:88])

    def _lcw(self, bits: np.ndarray, hit: SyncHit, ctx: DecoderContext) -> None:
        """Link Control Word: full TIA-102.AABF-D catalog in lcw.py
        (reference p25_lcw.c formats + MFID90/A4/D8 vendor opcodes)."""
        from dsdneo_tpu_torch.protocol.p25.lcw import decode_lcw
        decode_lcw(bits, hit, ctx, self)

    # -- LDU2 / HDU (voice continuation / header) -------------------------
    def _ldu2(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> None:
        if reader.remaining() < 820:
            return
        imbe = []
        hexwords = np.zeros(24, dtype=np.int64)
        w = 0
        for seg in range(8):
            bits, _ = reader.read_bits(72)
            imbe.append(bits)
            if 1 <= seg <= 6:
                vals, _errs = self._read_hexwords(reader, 4)
                hexwords[w:w + 4] = vals
                w += 4
            elif seg == 7:
                reader.read(16)
        bits, _ = reader.read_bits(72)
        imbe.append(bits)
        code = rs.rs_24_16_9()
        dec, nerr = code.decode(hexwords)
        ess_next = None
        if nerr >= 0:
            es_bits = np.zeros(96, dtype=np.uint8)
            for i in range(16):
                for j in range(6):
                    es_bits[i * 6 + j] = (dec[i] >> (5 - j)) & 1
            algid = _bits_to_int(es_bits[72:80])
            kid = _bits_to_int(es_bits[80:96])
            mi = _bits_to_int(es_bits[0:72])
            ess_next = (algid, kid, mi)
            ctx.emit(f" LDU2 ALG ID [{algid:02X}] KEY ID [{kid:04X}]",
                     "p25p1", hit.pos, algid=algid, kid=kid)
        ctx.emit(" LDU2 VOICE (9 IMBE frames)", "p25p1", hit.pos,
                 imbe=np.stack(imbe))
        # LDU2's own voice continues the PRIOR superframe keystream; the
        # new ESS takes effect only afterwards, when the offset resets
        # (reference ldu2_collect_voice_symbols: dropL=267/octet=0 set
        # after the 9 frames, p25p1_ldu2.c:238-239).
        self._voice(imbe, ctx)
        s2 = ctx.state
        if ess_next is not None:
            s2.payload_algid, s2.payload_kid, s2.payload_mi = ess_next
        s2.ks_offset = 0

    def _hdu(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> None:
        """Header Data Unit: 36 Golay(18,6)-protected hexbits, RS(36,20,17)."""
        if reader.remaining() < 350:
            return
        gol = blockcodes.golay_18_6_8()
        hexwords = np.zeros(36, dtype=np.int64)
        for i in range(36):
            bits, rel = reader.read_bits(9)
            m, _e = gol.decode(bits, rel)
            hexwords[i] = m
        code = rs.rs_36_20_17()
        dec, nerr = code.decode(hexwords)
        if nerr < 0:
            ctx.emit(" HDU RS FEC ERR", "p25p1", hit.pos)
            return
        bits120 = np.zeros(120, dtype=np.uint8)
        for i in range(20):
            for j in range(6):
                bits120[i * 6 + j] = (dec[i] >> (5 - j)) & 1
        # HDU layout (reference p25p1_hdu.c hdu_extract_mi_algid_kid,
        # rows mapped to transmit order): MI 0:72, MFID 72:80,
        # ALGID 80:88, KID 88:104, TGID 104:120
        mfid = _bits_to_int(bits120[72:80])
        algid = _bits_to_int(bits120[80:88])
        kid = _bits_to_int(bits120[88:104])
        tgid = _bits_to_int(bits120[104:120])
        mi = _bits_to_int(bits120[0:72])
        s2 = ctx.state
        s2.payload_algid, s2.payload_kid, s2.payload_mi = algid, kid, mi
        s2.ks_offset = 0            # superframe start (hdu.c:429 dropL=267)
        ctx.emit(f" HDU ALG ID [{algid:02X}] KEY ID [{kid:04X}] TG [{tgid}]"
                 + (f" MFID [{mfid:02X}]" if mfid else ""),
                 "p25p1", hit.pos, algid=algid, tgid=tgid)
