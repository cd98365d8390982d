"""DMR data-call path: data header parse, rate-1/2 / rate-3/4 blocks,
multi-block PDU assembly with CRC32, and short-data text rendering.

Reference parity: src/protocol/dmr/dmr_block.c (header fields
dmr_dheader_parse_fields, assembler + ComputeCrc32Bit byte-swap
convention), dmr_dburst.c (per-dtype CRC masks), dmr_utils.c
(ComputeCrc9Bit / ComputeCrc32Bit).

The port's own copy of ``dsdneo_tpu/protocol/dmr/data.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dsdneo_tpu_torch.fec import crc

DPF_NAMES = {
    0: "Unified Data Transport (UDT) ", 1: "Response Packet ",
    2: "Unconfirmed Delivery ", 3: "Confirmed Delivery ",
    13: "Short Data: Defined ", 14: "Short Data: Raw or S/P ",
    15: "Extended",
}

SAP_NAMES = {
    0: "UDT Data", 2: "TCP Comp", 3: "UDP Comp", 4: "IP Based",
    5: "ARP Prot", 9: "EXTD HDR", 10: "Short DT",
}

DD_FORMATS = {
    0: "Binary", 1: "BCD", 2: "7-bit Char", 3: "IEC 8859-1", 18: "UTF-8",
    19: "UTF-16", 21: "UTF-16LE",
}

UDT_FORMATS = {0: "Binary", 1: "MS/TG Adr", 2: "4-bit BCD", 3: "ISO7 Char",
               4: "ISO8 Char", 5: "NMEA LOCN", 6: "IP Addr", 7: "UTF-16",
               10: "Mixed UTF", 11: "LIP LOCN"}


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def crc9_bits(bits: np.ndarray) -> int:
    """ETSI DMR CRC-9, poly 0x059, final inversion (reference
    dmr_utils.c ComputeCrc9Bit)."""
    c = 0
    for b in bits:
        if ((c >> 8) & 1) ^ int(b):
            c = ((c << 1) ^ 0x059) & 0x1FF
        else:
            c = (c << 1) & 0x1FF
    return c ^ 0x1FF


def crc32_bits(bits: np.ndarray) -> int:
    """ETSI DMR CRC-32 (poly 0x04C11DB7, zero init) with the reference's
    byte-reversed return convention (dmr_utils.c ComputeCrc32Bit)."""
    c = 0
    for b in bits:
        if ((c >> 31) & 1) ^ int(b):
            c = ((c << 1) ^ 0x04C11DB7) & 0xFFFFFFFF
        else:
            c = (c << 1) & 0xFFFFFFFF
    return (((c & 0xFF) << 24) | ((c & 0xFF00) << 8)
            | ((c >> 8) & 0xFF00) | (c >> 24))


@dataclass
class DataHeader:
    gi: int = 0
    response_req: int = 0
    dpf: int = 0
    sap: int = 0
    poc: int = 0           # pad octet count
    target: int = 0
    source: int = 0
    full_final: int = 0
    sd_bp: int = 0
    blocks: int = 0        # blocks to follow
    fsn: int = 0
    dd_format: int = 0
    udt_format: int = 0
    udt_blocks: int = 0
    confirmed: bool = False

    def describe(self) -> str:
        dpf_s = DPF_NAMES.get(self.dpf, f"Reserved/Unknown DPF {self.dpf:X} ")
        gi_s = "" if self.dpf == 15 else ("Group - " if self.gi else "Indiv - ")
        line = f"Data Header - {gi_s}{dpf_s}"
        if self.response_req and self.dpf != 15:
            line += "- Response Requested "
        if self.dpf != 15:
            line += f"- Source: {self.source} Target: {self.target} "
        sap_s = SAP_NAMES.get(self.sap, "Reserved")
        if self.dpf == 0:
            fmt_s = UDT_FORMATS.get(self.udt_format, "Reserved")
            line += (f"\n  SAP {self.sap:02d} [{sap_s}] - FMT {self.udt_format}"
                     f" [{fmt_s}] - BLOCKS {self.udt_blocks}")
        elif self.dpf in (2, 3):
            line += (f"\n  SAP {self.sap:02d} [{sap_s}] - FINAL {self.full_final}"
                     f" - BLOCKS {self.blocks:02d} - PAD {self.poc:02d}"
                     f" - FSN {self.fsn}")
        elif self.dpf == 13:
            dd_s = DD_FORMATS.get(self.dd_format, "Reserved")
            line += f"\n  SAP {self.sap:02d} [{sap_s}] - DD {dd_s}"
        return line


def parse_data_header(bits96: np.ndarray) -> DataHeader | None:
    """96-bit BPTC payload (dtype 0x06, CRC16 mask 0xCCCC) → DataHeader.

    Field layout per reference dmr_block.c dmr_dheader_parse_fields."""
    ccrc = crc.crc16_bits(bits96[:80], init=0, xorout=0xFFFF) ^ 0xCCCC
    if ccrc != _bti(bits96[80:96]):
        return None
    h = DataHeader()
    h.gi = int(bits96[0])
    h.response_req = int(bits96[1])
    h.dpf = _bti(bits96[4:8])
    h.sap = _bti(bits96[8:12])
    h.poc = _bti(bits96[12:16]) + (int(bits96[3]) << 4)
    h.target = _bti(bits96[16:40])
    h.source = _bti(bits96[40:64])
    h.full_final = int(bits96[64])
    h.blocks = _bti(bits96[65:72])
    h.fsn = _bti(bits96[76:80])
    h.dd_format = _bti(bits96[64:70])
    h.sd_bp = _bti(bits96[72:80])      # short-data bit padding
    h.udt_format = _bti(bits96[12:16])
    h.udt_blocks = _bti(bits96[70:72]) + 1
    h.confirmed = h.dpf == 3
    if h.dpf == 0:
        h.blocks = h.udt_blocks
    elif h.dpf in (13, 14):
        # short data: appended blocks from the AB field
        h.blocks = ((_bti(bits96[2:4]) << 4) | _bti(bits96[12:16]))
    return h


@dataclass
class PduAssembler:
    """Per-slot multi-block PDU accumulator (reference
    dmr_block.c dmr_block_assembler, type 1)."""
    header: DataHeader | None = None
    header_bits: np.ndarray | None = None
    data: list = field(default_factory=list)     # decoded block bytes
    count: int = 0

    def start(self, header: DataHeader,
              header_bits: np.ndarray | None = None) -> None:
        self.header = header
        self.header_bits = header_bits
        self.data = []
        self.count = 0

    def add_block(self, block_bytes: np.ndarray) -> str | None:
        """Append one block; returns a completion summary when the PDU
        finishes (CRC32 verdict + any decodable text; UDT runs decode
        per the UDT format field), else None."""
        if self.header is None:
            return None
        self.data.append(np.asarray(block_bytes, dtype=np.uint8))
        self.count += 1
        if self.count < max(self.header.blocks, 1):
            return None
        payload = np.concatenate(self.data)
        hdr, hdr_bits = self.header, self.header_bits
        self.header = None
        if hdr.dpf == 0 and hdr_bits is not None:
            # UDT: header + appended blocks decode as one short-data
            # message (reference dmr_block.c dmr_udt_decoder)
            from dsdneo_tpu_torch.protocol.dmr.udt import decode_udt
            bits = np.concatenate(
                [np.asarray(hdr_bits, np.uint8)]
                + [np.unpackbits(d) for d in self.data])
            return decode_udt(bits, app_blocks=len(self.data))
        return self._finish(payload, hdr)

    def _finish(self, payload: np.ndarray,
                hdr: DataHeader | None = None) -> str:
        if len(payload) < 4:
            return " | PDU short"
        crc_ext = _bti(np.unpackbits(payload[-4:]))
        # CRC32 runs over 16-bit-swapped byte order (reference
        # dmr_block_type1_pack_crc_bits)
        swapped = payload[:-4].copy()
        for i in range(0, len(swapped) - 1, 2):
            swapped[i], swapped[i + 1] = swapped[i + 1], swapped[i]
        crc_cmp = crc32_bits(np.unpackbits(swapped))
        verdict = "CRC32 OK" if crc_cmp == crc_ext else "CRC32 ERR"
        body = payload[:-4]
        if hdr is not None and hdr.dpf == 13 and 0x12 <= hdr.dd_format <= 0x18:
            # defined short data with a declared Unicode encoding
            # (reference dmr_sd_pdu_process dmr_pdu.c:201-244 +
            # dmr_decode_defined_short_data dmr_text.c:359-382)
            d = decode_defined_short_data(
                hdr.dd_format, body, hdr.sd_bp, verdict == "CRC32 OK")
            if d:
                return f" | Short Data ({len(payload)} bytes) {verdict}{d}"
        if hdr is not None and hdr.sap == 1 and len(body) > 7 \
                and int(body[1]) == 0x10:
            # Motorola MNIS proprietary wrapper: type at byte 4,
            # payload from byte 7 (reference
            # dmr_block_type1_handle_mnis dmr_block.c:1287-1307)
            mnis_type = int(body[4])
            label = {0x01: "MNIS LOCN;", 0x11: "MNIS LRRP;",
                     0x33: "MNIS ARS;", 0x88: "MNIS XCMP;"}.get(
                         mnis_type, f"Unknown MNIS Type: {mnis_type:02X};")
            d = f" | IP PDU ({len(payload)} bytes) {verdict} {label}"
            inner = body[7:]
            if mnis_type == 0x11:
                from dsdneo_tpu_torch.protocol.dmr.lrrp import parse_lrrp
                fix = parse_lrrp(inner)
                if fix is not None:
                    d += "\n " + fix.describe()
            elif mnis_type in (0x01, 0x33):
                text = "".join(chr(int(c)) if 0x20 <= int(c) < 0x7F
                               else " " for c in inner).strip()
                if text:
                    d += f" {text}"
                if mnis_type == 0x01:
                    from dsdneo_tpu_torch.protocol.dmr.gps import decode_locn
                    locn = decode_locn(inner)
                    if locn:
                        d += "\n" + locn
            return d
        if hdr is not None and hdr.sap in (2, 3, 4):
            # SAP routing on completed PDUs (reference
            # dmr_block_type1_handle_sap: 4 = IPv4, 2/3 = compressed)
            from dsdneo_tpu_torch.protocol.dmr.ip_pdu import (
                decode_ip_pdu, decode_udp_comp_pdu)
            d = (decode_ip_pdu(body) if hdr.sap == 4
                 else decode_udp_comp_pdu(body))
            if d:
                return f" | IP PDU ({len(payload)} bytes) {verdict}" + d
        from dsdneo_tpu_torch.protocol.dmr.lrrp import (
            looks_like_lrrp, parse_lrrp)
        if looks_like_lrrp(body):
            fix = parse_lrrp(body)
            if fix is not None:
                return (f" | LRRP ({len(payload)} bytes) {verdict}\n "
                        f"{fix.describe()}")
        text = _printable(body)
        tail = f" '{text}'" if text else ""
        return (f" | Multi Block PDU ({len(payload)} bytes) {verdict}{tail}")


def _printable(data: np.ndarray) -> str:
    """Best-effort text rendering of a completed PDU payload."""
    b = bytes(int(x) for x in data)
    for codec in ("utf-8", "latin-1"):
        try:
            s = b.decode(codec)
        except UnicodeDecodeError:
            continue
        s = "".join(ch for ch in s if ch.isprintable())
        if len(s) >= 4:
            return s[:96]
        return ""
    return ""


_DD_ENCODINGS = {0x12: ("UTF-8", "utf-8"), 0x13: ("UTF-16", "utf-16"),
                 0x14: ("UTF-16BE", "utf-16-be"),
                 0x15: ("UTF-16LE", "utf-16-le"),
                 0x16: ("UTF-32", "utf-32"), 0x17: ("UTF-32BE", "utf-32-be"),
                 0x18: ("UTF-32LE", "utf-32-le")}


def decode_defined_short_data(dd_format: int, body: np.ndarray,
                              bit_padding: int, crc_ok: bool) -> str | None:
    """Defined short data text (reference dmr_text.c
    dmr_decode_defined_short_data): decode per the declared Unicode
    encoding after stripping the header's bit padding; a malformed
    UTF-32 payload with a good CRC retries as UTF-16BE (the
    compatibility path for radios that mislabel the encoding)."""
    declared, codec = _DD_ENCODINGS[dd_format]
    total_bits = len(body) * 8 - bit_padding
    if total_bits < 0 or total_bits % 8:
        return f"\n Short Data Text: invalid bit padding ({bit_padding} bits)"
    raw = bytes(int(x) for x in body[:total_bits // 8])

    def try_decode(c):
        try:
            s = raw.decode(c)
        except (UnicodeDecodeError, LookupError):
            return None
        return "".join(ch if ch.isprintable() or ch == " " else " "
                       for ch in s).strip()

    text = try_decode(codec)
    effective = declared
    if text is None and dd_format == 0x16 and crc_ok:
        text = try_decode("utf-16-be")
        effective = "UTF-16BE compatibility"
    if text is None:
        return (f"\n Short Data Text (declared {declared};"
                " undecodable payload)")
    return (f"\n Short Data Text (declared {declared};"
            f" decoded {effective}): {text}")
