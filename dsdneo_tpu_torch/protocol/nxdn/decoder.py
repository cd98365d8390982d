"""The NXDN message catalog (host, numpy only).

The port's own copy of what the batched RCCH monitor
(``engine.ccbatch.BatchedNxdnControlPipeline``) parses with, from
``dsdneo_tpu/protocol/nxdn/decoder.py``: ``NxdnDecoder._message`` and
what it calls (``_dcall_data``, ``_alias``, ``_nxdn_crc32``,
``_nxdn_gps_report``), with the label tables and the CAC CRC.  The
frame walk (``handle``), the SACCH/FACCH readers and the voice path are
not here.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.base import DecoderContext

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


class NxdnDecoder:
    protocol = "nxdn"

    def __init__(self):
        self.segments = np.ones((4, 18), dtype=np.uint8)
        self.seg_ok = [False] * 4
        self.part_of_frame = -1
        self.last_ran = -1
        self.variant = None  # "NXDN48"/"NXDN96" (set from symbol rate)
        self.alias_blocks = [""] * 4
        self.dcall = None    # data-call assembly state (header → blocks)

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
