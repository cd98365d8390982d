"""D-STAR host decoding: the header scrambler, CRC-16/X25 and the event
lines of the RF header and the slow data (host, numpy).

The port's own copy of what ``engine.dstarbatch`` calls on the host from
``dsdneo_tpu/protocol/dstar/decoder.py`` (``SD_SCRAMBLE``,
``_header_scramble``, ``crc16_x25``, ``_ascii``, ``_sd_ascii``,
``_sd_aprs``, ``slow_data_line``, ``header_line``) and
``voicing_activity`` of ``protocol/dstar/ambe2400.py``.  The 60 slow-data
bytes carry 6-byte blocks of radio text, a DPRS position or a copy of
the RF header (flags, RPT2/RPT1/URCALL/MYCALL, CRC-16/X25).
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.base import DecoderContext

# first 24 bits of the D-STAR scrambling sequence (x^7+x^4+1 LFSR), as a
# repeating XOR pattern for the slow-data bytes
SD_SCRAMBLE = np.array([0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1,
                        0, 0, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1], dtype=np.uint8)


def _header_scramble() -> np.ndarray:
    """127-bit PN from the x⁷+x⁴+1 LFSR, seed 0x07, MSb out (reference
    dstar_header_utils.c dstar_fill_scrambler_sequence)."""
    reg = 0x07
    out = np.zeros(127, dtype=np.uint8)
    for i in range(127):
        out[i] = (reg >> 6) & 1
        fb = ((reg >> 6) ^ (reg >> 3)) & 1
        reg = ((reg << 1) & 0x7E) | fb
    return out


def crc16_x25(data: np.ndarray) -> int:
    """CRC-16/X25 (poly 0x8408 reflected, init/xorout 0xFFFF), returned
    byte-swapped as the reference's dstar_crc16 does."""
    crc = 0xFFFF
    for byte in data:
        crc ^= int(byte)
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ 0x8408
            else:
                crc >>= 1
    crc = (~crc) & 0xFFFF
    return ((crc << 8) | (crc >> 8)) & 0xFFFF


def _ascii(b: np.ndarray) -> str:
    return "".join(chr(int(c)) if 0x20 <= c <= 0x7E else " " for c in b)


def _sd_ascii(sd_bytes) -> str:
    """Printable payload chars, skipping every 6th (block header)
    byte (reference dstar_sd_emit_truncated_ascii)."""
    out = []
    for i in range(1, 59):
        if i % 6 == 0:
            continue
        b = int(sd_bytes[i])
        if 0x19 < b < 0x7E + 1:
            out.append(chr(b))
    return "".join(out).strip()


def _sd_aprs(sd_bytes) -> str:
    """DPRS position from a $$CRC sentence: '!' marker then
    ddmm.ssh/dddmm.ssh (reference dstar_sd_handle_aprs +
    print_aprs_lat/lon)."""
    aprs = []
    for i in range(1, 60):
        if i % 6 == 0:
            continue
        aprs.append(int(sd_bytes[i]))
    start = -1
    for i in range(30, 40):
        if i < len(aprs) and aprs[i] == 0x21:      # '!'
            start = i + 1
            break
    if start < 0 or start + 18 >= len(aprs):
        return ""

    def take(n, skip=0):
        nonlocal start
        v = "".join(chr(c) if 0x19 < c < 0x7F else "?"
                    for c in aprs[start:start + n])
        start += n + skip
        return v

    lat_d = take(2)
    lat_m = take(2, 1)
    lat_s = take(2)
    ns = chr(aprs[start]) if aprs[start] in (0x4E, 0x53) else "?"
    start += 2                                 # hemisphere + '/'
    lon_d = take(3)
    lon_m = take(2, 1)
    lon_s = take(2)
    ew = chr(aprs[start]) if aprs[start] in (0x45, 0x57) else "?"
    return (f"APRS - Lat: {lat_d}d {lat_m}m {lat_s}s {ns}"
            f" ; Lon: {lon_d}d {lon_m}m {lon_s}s {ew} ;")


def slow_data_line(sd_bytes: np.ndarray, ctx: DecoderContext) -> str:
    """60 descrambled slow-data bytes → the event-line payload (radio
    text, a DPRS position, or the RF header's copy)."""
    if sd_bytes[0] == 0x40:
        # 20-char radio text in 5-byte blocks (reference
        # dstar_sd_handle_text_message)
        txt = _sd_ascii(sd_bytes)
        ctx.state.dstar_text = txt
        return f"SLOW DATA TEXT: {txt}"
    if sd_bytes[0] == 0x35:
        # fixed form: type field "$$CRC" → DPRS/APRS position
        # (reference dstar_sd_handle_fixed_form / handle_aprs)
        kind = "".join(chr(b) if 0x19 < b < 0x7F else " "
                       for b in sd_bytes[1:7])
        if kind.startswith("$$CRC"):
            gps = _sd_aprs(sd_bytes)
            if gps:
                ctx.state.dstar_gps = gps
                return f"SLOW DATA DATA: {_sd_ascii(sd_bytes)}\n {gps}"
            return f"SLOW DATA DATA: {_sd_ascii(sd_bytes)}"
        return f"SLOW DATA TEXT: {_sd_ascii(sd_bytes)}"
    if sd_bytes[0] != 0x55:
        return "SLOW DATA"
    blk = int(sd_bytes[0] & 0xF) + 1
    hd = np.zeros(60, dtype=np.uint8)
    j = 0
    for i in range(50):
        j += 1
        hd[i] = sd_bytes[j] if j < 60 else 0
        for marker in range(1, 10):
            if j == blk * marker - 1:
                j += 1
    crc_ext = (int(hd[39]) << 8) | int(hd[40])
    crc_cmp = crc16_x25(hd[:39])
    if crc_cmp != crc_ext:
        return "SLOW DATA - HEADER FORMAT (CRC ERR)"
    rpt2 = _ascii(hd[3:11]).strip()
    rpt1 = _ascii(hd[11:19]).strip()
    dst = _ascii(hd[19:27])
    src = _ascii(hd[27:39])
    ctx.state.last_src = src.strip()
    flags = int(hd[0])
    flagstr = ""
    for bit, name in ((0x80, " DATA"), (0x40, " REPEATER"),
                      (0x20, " INTERRUPTED"), (0x10, " CONTROL SIGNAL"),
                      (0x08, " URGENT")):
        if flags & bit:
            flagstr += name
    return (f"RPT 2: {rpt2} RPT 1: {rpt1} DST: {dst} SRC: {src}{flagstr}")


def header_line(hdr: np.ndarray, ctx: DecoderContext
                ) -> tuple[str, bool, dict]:
    """41 RF-header octets → (event-line payload, crc_ok, fields)."""
    crc_ext = (int(hdr[39]) << 8) | int(hdr[40])
    crc_cmp = crc16_x25(hdr[:39])
    rpt2 = _ascii(hdr[3:11])
    rpt1 = _ascii(hdr[11:19])
    dst = _ascii(hdr[19:27])
    src = _ascii(hdr[27:39])
    flags = ""
    for bit, name in ((0x80, " DATA"), (0x40, " REPEATER"),
                      (0x20, " INTERRUPTED"), (0x10, " CONTROL SIGNAL"),
                      (0x08, " URGENT")):
        if hdr[0] & bit:
            flags += name
    crc_ok = crc_cmp == crc_ext
    tag = "" if crc_ok else " (CRC ERR)"
    if crc_ok:
        ctx.state.last_src = src.strip()
    line = (f"RPT 2: {rpt2} RPT 1: {rpt1} DST: {dst} SRC: {src}"
            f"{flags}{tag}")
    return line, crc_ok, dict(rpt1=rpt1, rpt2=rpt2, dst=dst, src=src)


def voicing_activity(bits49: np.ndarray) -> int:
    """The band-voicing/activity field of 49 AMBE parameter bits, bits
    [42:46) least significant first: 0 in silence, 8-15 in speech."""
    b = np.asarray(bits49, dtype=np.uint8)
    return int(b[42] | (b[43] << 1) | (b[44] << 2) | (b[45] << 3))
