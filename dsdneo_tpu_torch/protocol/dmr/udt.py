"""DMR Unified Data Transport (UDT) completed-payload decode.

A UDT short-data message is a data header (DPF 0) plus 1-4 appended
rate-1/2 blocks; the last 16 bits of the appended run are a CRC-CCITT16
over the rest (reference dmr_block.c dmr_block_type2_update_crc
is_udt path).  The completed bit buffer (header 96 bits + appended
blocks) is decoded per the header's second format field
(dmr_udt_prepare_context :656-699 and dmr_udt_decode_format
:963-989): binary, appended addressing, dialer BCD, ISO7 packed text,
ISO8 text, NMEA location, IP address, UTF-16 text, mixed
address+UTF-16, and LIP location.

The port's own copy of ``dsdneo_tpu/protocol/dmr/udt.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import crc


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _bcd_char(d: int) -> str:
    if d < 10:
        return chr(0x30 + d)
    if d == 10:
        return "*"
    if d == 11:
        return "#"
    if d == 15:
        return " "
    return f"R:{d:X}"


def decode_udt(cs_bits: np.ndarray, app_blocks: int) -> str:
    """Decode a completed UDT run.

    *cs_bits*: header (96) + appended blocks (96 each) as one bit
    vector.  *app_blocks*: number of appended blocks (1-4).  Returns
    the detail string (reference prints the same fields to stderr)."""
    b = np.asarray(cs_bits, dtype=np.uint8)
    app_blocks = max(1, min(int(app_blocks), 4))
    need = 96 + 96 * app_blocks
    if len(b) < need:
        b = np.concatenate([b, np.zeros(need - len(b), np.uint8)])

    # appended-run CRC16 (reference dmr_block_type2_update_crc)
    app = b[96:96 + 96 * app_blocks]
    crc_ok = False
    if len(app) >= 16:
        ext = _bti(app[-16:])
        cmp_ = crc.crc16_bits(app[:len(app) - 16], init=0, xorout=0xFFFF)
        crc_ok = ext == cmp_

    fmt2 = _bti(b[12:16])
    target = _bti(b[16:40])
    source = _bti(b[40:64])
    padnib = _bti(b[64:69])
    uab = _bti(b[70:72]) + 1
    payload_bits = max(0, 96 * app_blocks - 16 - 4 * padnib)

    out = f" | UDT SRC: {source}; TGT: {target}; "
    if not crc_ok:
        out += "CRC16 ERR; "

    if fmt2 == 0x00:
        # reference renders binary payloads as filtered UTF-8 text
        # (dmr_udt_handle_binary -> utf8_to_text)
        out += "Binary Data;"
        nbytes = min(payload_bits // 8, 48)
        if nbytes > 0:
            text = "".join(
                chr(c) if 0x20 <= c < 0x7F else " "
                for c in (_bti(b[96 + 8 * i:104 + 8 * i])
                          for i in range(nbytes))).strip()
            if text:
                out += f" {text}"
    elif fmt2 == 0x01:
        res = _bti(b[96:103])
        ok = int(b[103])
        n = max(0, payload_bits - 8) // 24
        out += "Appended Addressing; "
        if res:
            out += f"RES: {res}; "
        out += f"OK: {ok}; ADDR:"
        for i in range(n):
            out += f" {_bti(b[104 + 24 * i:128 + 24 * i])};"
    elif fmt2 == 0x02:
        digits = "".join(_bcd_char(_bti(b[96 + 4 * i:100 + 4 * i]))
                         for i in range(payload_bits // 4))
        out += f"Dialer BCD: {digits}"
    elif fmt2 == 0x03:
        text = "".join(
            chr(c) if 0x20 <= c <= 0x7E else " "
            for c in (_bti(b[96 + 7 * i:103 + 7 * i])
                      for i in range(payload_bits // 7)))
        out += f"ISO7 Text: {text}"
    elif fmt2 == 0x04:
        text = "".join(
            chr(c) if 0x20 <= c <= 0x7E else " "
            for c in (_bti(b[96 + 8 * i:104 + 8 * i])
                      for i in range(payload_bits // 8)))
        out += f"ISO8 Text: {text}"
    elif fmt2 == 0x05:
        from dsdneo_tpu_torch.protocol.dmr.gps import decode_nmea_iec
        out += "NMEA"
        if int(b[96]):
            out += " Encrypted Format"
        elif uab in (1, 2):
            out += decode_nmea_iec(b[96:], uab)
        elif uab == 3:
            out += f" Unspecified MFID Format: {_bti(b[184:192]):02X};"
        else:
            out += " Reserved Format;"
    elif fmt2 == 0x06:
        if uab == 1:
            out += ("IP4: "
                    + ".".join(str(_bti(b[96 + 8 * i:104 + 8 * i]))
                               for i in range(4)))
        else:
            out += ("IP6: "
                    + ":".join(f"{_bti(b[96 + 16 * i:112 + 16 * i]):04X}"
                               for i in range(8)))
    elif fmt2 == 0x07:
        text = "".join(
            chr(c) if 0x20 <= c <= 0xFFFF and c != 0x7F else " "
            for c in (_bti(b[96 + 16 * i:112 + 16 * i])
                      for i in range(payload_bits // 16)))
        out += f"UTF16 Text: {text}"
    elif fmt2 in (0x08, 0x09):
        out += f"MFID SPEC {fmt2:02X};"
    elif fmt2 == 0x0A:
        addr = _bti(b[104:128])
        n = max(0, payload_bits - 32) // 16
        text = "".join(
            chr(c) if 0x20 <= c <= 0xFFFF and c != 0x7F else " "
            for c in (_bti(b[128 + 16 * i:144 + 16 * i])
                      for i in range(n)))
        out += f"Address: {addr}; UTF16 Text: {text}"
    elif fmt2 == 0x0B:
        from dsdneo_tpu_torch.protocol.dmr.gps import decode_lip
        out += decode_lip(b[96:])
    else:
        out += f"Reserved {fmt2:02X};"
    return out
