"""DMR confirmed-data IP stack: IPv4 header, ICMP, UDP service ports,
TMS text messages, and the compressed-UDP (SAP 2/3) form.

Reference parity: src/protocol/dmr/dmr_pdu.c decode_ip_pdu
(:861-925; v4/ihl validation, 24-bit radio IDs from the low IP
octets), decode_ip_pdu_handle_udp (:769-790; dispatch on destination
port), the port catalog in decode_ip_pdu_handle_udp_service_core/_ext
(:643-760), decode_ip_pdu_handle_udp_tms (:560-604; length-prefixed
UTF-16BE with optional address + extension octets), and
dmr_udp_comp_pdu (:397-436; compressed-IP index + port-index form
with UTF-16 text / LIP payloads).

The port's own copy of ``dsdneo_tpu/protocol/dmr/ip_pdu.py`` (numpy
only); the P25 Phase 1 MPDU path calls it.
"""

from __future__ import annotations

import numpy as np


def _u16(b, i) -> int:
    return (int(b[i]) << 8) | int(b[i + 1])


def _u24(b, i) -> int:
    return (int(b[i]) << 16) | (int(b[i + 1]) << 8) | int(b[i + 2])


def _utf16(data) -> str:
    """Big-endian UTF-16 printable rendering (reference
    utf16_to_text): NUL pads as '_', 0x040D line breaks as ' / '."""
    out = []
    for i in range(0, len(data) - 1, 2):
        ch = _u16(data, i)
        if ch >= 0x20 and ch != 0x040D:
            out.append(chr(ch) if ch < 0x10000 else "?")
        elif ch == 0:
            out.append("_")
        elif ch == 0x040D:
            out.append(" / ")
    return "".join(out)


def _utf8(data, limit) -> str:
    return "".join(chr(int(c)) if 0x20 <= int(c) < 0x7F else " "
                   for c in data[:limit])


def _tms(payload) -> str:
    """UDP port 4007 TMS (reference decode_ip_pdu_handle_udp_tms):
    16-bit length, header octet with ack nibble, optional
    length-prefixed UTF-16 address, extension octets while the
    continuation bit is set, then UTF-16BE text."""
    if len(payload) < 4:
        return " TMS Truncated;"
    tms_len = _u16(payload, 0)
    out = f" TMS Len: {tms_len}; "
    ptr = 2
    hdr = int(payload[ptr])
    ptr += 1
    ack = hdr & 0xF
    adl = int(payload[ptr])
    ptr += 1
    if adl:
        ptr -= 1
        if adl < 4 or ptr + adl >= len(payload):
            return out + "TMS Truncated;"
        # reference zeroes the length octet then reads adl-4 UTF-16
        # bytes starting at it (decode_ip_pdu_parse_udp_tms_address)
        out += (f"Address Len: {adl}; Address: "
                + _utf16(np.concatenate(
                    [np.zeros(1, np.uint8),
                     payload[ptr + 1:ptr + adl - 4]])) + "; ")
        ptr += adl + 1
    if ptr >= len(payload):
        return out + "TMS Truncated;"
    more = int(payload[ptr]) >> 7
    while more:
        b1 = int(payload[ptr])
        ptr += 1
        more = b1 >> 7
        if more:
            ptr += 1
        if ptr >= len(payload):
            return out + "TMS Truncated;"
    if ack:
        return out + "Acknowledgment;"
    if ptr % 2 == 0:
        ptr += 1
    if tms_len > 3:
        consumed = ptr - 3
        if consumed >= tms_len:
            return out + "TMS Truncated;"
        tms_len -= consumed
    ptr -= 2
    if ptr < 0 or ptr >= len(payload):
        return out + "TMS Truncated;"
    span = min(tms_len, len(payload) - ptr)
    return out + "Text: " + _utf16(payload[ptr:ptr + span])


_CELLOCATOR_TYPES = {
    1: "Platform Manifest Data", 2: "CAN Data", 3: "CAN Trigger Data",
    4: "Time and Location Data", 5: "Accelerometer Data",
    6: "PSP Alarm System Data", 7: "Usage Counter Data",
    8: "Command Authentication Table Data", 9: "GSM Neighbor List Data",
    10: "Maintenance Server Platform Manifest Data",
}


def _cellocator(payload) -> str:
    """Port 231 Cellocator packet: 4-char magic + type octet
    (reference dsd_gps.c decode_cellocator)."""
    out = " Cellocator:"
    if len(payload) >= 5:
        magic = _utf8(payload, 4)
        out = f" {magic} Cellocator:" if magic.strip() else out
        out += " " + _CELLOCATOR_TYPES.get(int(payload[4]),
                                           "Unknown Data") + ";"
    return out


_PORT_LABELS = {
    4004: "XCMP;", 4008: "Telemetry;",
    4009: "OTAP;", 4012: "Battery Management;",
    4013: "Job Ticket Server;", 4069: "TRBOnet SCADA;",
    9361: "Atlas Data Registration Server;",
}


def _udp_service(port, payload, data) -> str:
    from dsdneo_tpu_torch.protocol.dmr.lrrp import parse_lrrp
    if port == 231:
        return _cellocator(payload)
    if port in _PORT_LABELS:
        return " " + _PORT_LABELS[port]
    if port in (4001, 49198):
        out = " LRRP;" if port == 4001 else " P25 Tier 2 Location Service;"
        fix = parse_lrrp(payload)
        if fix is not None:
            out += "\n " + fix.describe()
        return out
    if port == 4005:
        return " ARS; " + _utf8(payload, 10)
    if port == 4007:
        return _tms(payload)
    if port == 5007:
        # VTX STD TMS: UTF-16 text from offset 21
        text = _utf16(payload[21:]) if len(payload) > 21 else ""
        return " VTX STD TMS;" + (f" Text: {text}" if text else " No Text;")
    if port == 5016:
        return " ETSI TMS; " + _utf16(payload)
    if port == 5017:
        from dsdneo_tpu_torch.protocol.dmr.gps import decode_lip
        return " " + decode_lip(np.unpackbits(
            np.asarray(payload, np.uint8)))
    return f" UDP Port {port};"


def decode_ip_pdu(data: np.ndarray) -> str | None:
    """IPv4 PDU (SAP 4); returns None when *data* is not a v4 packet
    so the caller can fall back to the generic dump."""
    b = np.asarray(data, dtype=np.uint8)
    if len(b) < 20:
        return None
    version, ihl = int(b[0]) >> 4, int(b[0]) & 0xF
    if version != 4 or ihl < 5:
        return None
    hlen = ihl * 4
    if hlen > len(b):
        return None
    tlen = _u16(b, 2)
    eff = min(tlen, len(b)) if tlen >= hlen else len(b)
    prot = int(b[9])
    src24, dst24 = _u24(b, 13), _u24(b, 17)
    out = (f"\n SRC(24): {src24:08d};"
           f" IP: {int(b[12]):03d}.{int(b[13]):03d}"
           f".{int(b[14]):03d}.{int(b[15]):03d};"
           f"\n DST(24): {dst24:08d};"
           f" IP: {int(b[16]):03d}.{int(b[17]):03d}"
           f".{int(b[18]):03d}.{int(b[19]):03d};")
    if prot == 0x01:                          # ICMP
        if eff < hlen + 4:
            return out
        itype, icode = int(b[hlen]), int(b[hlen + 1])
        out += f"\n ICMP Protocol; Type: {itype:02X}; Code: {icode:02X};"
        if itype == 3:
            out += " Destination" + {0: " Network", 1: " Host",
                                     2: " Protocol", 3: " Port"
                                     }.get(icode, "") + " Unreachable;"
        att = hlen + 8
        if eff > att and int(b[att]) == 0x45:
            inner = decode_ip_pdu(b[att:eff])
            if inner:
                out += "\n ------------Attached Message-------------" + inner
        return out
    if prot == 0x11:                          # UDP
        if eff < hlen + 8:
            return out + "\n Truncated UDP;"
        src_port, dst_port = _u16(b, hlen), _u16(b, hlen + 2)
        udp_len = _u16(b, hlen + 4)
        out += (f"\n UDP Protocol; SRC Port: {src_port:04d};"
                f" DST Port: {dst_port:04d}; Datagram Len: {udp_len};")
        pay_len = min(max(udp_len - 8, 0), eff - hlen - 8)
        payload = b[hlen + 8:hlen + 8 + pay_len]
        out += _udp_service(dst_port, payload, b)
        return out
    return out + f"\n Unknown IP Protocol: {prot:02X};"


_IDX_DESC = {0: "Radio Network", 1: "Reserved"}


def decode_udp_comp_pdu(data: np.ndarray) -> str | None:
    """Compressed UDP/IP (SAP 2/3; reference dmr_udp_comp_pdu): 16-bit
    context index, 4-bit src/dst address indices, 7-bit port indices
    (0 = extended ports follow), UTF-16 text / LIP payloads."""
    b = np.asarray(data, dtype=np.uint8)
    if len(b) < 5:
        return None
    ipid = _u16(b, 0)
    said, daid = int(b[2]) >> 4, int(b[2]) & 0xF
    opcode = (((int(b[3]) >> 7) & 1) << 1) | ((int(b[4]) >> 7) & 1)
    spid, dpid = int(b[3]) & 0x7F, int(b[4]) & 0x7F
    ptr = 5
    if spid == 0 and dpid == 0:
        if len(b) < 9:
            return None
        spid, dpid, ptr = _u16(b, 5), _u16(b, 7), 9
    elif spid == 0 or dpid == 0:
        if len(b) < 7:
            return None
        if spid == 0:
            spid = _u16(b, 5)
        else:
            dpid = _u16(b, 5)
        ptr = 7

    def pdesc(pid):
        if pid == 1:
            return "UTF-16BE Text Message"
        if pid == 2:
            return "Location Interface Protocol"
        return "Reserved" if pid < 191 else "Manufacturer Specific"

    out = (f"\n Compressed IP Idx: {ipid}; Opcode: {opcode};"
           f" Src Idx: {said}; Dst Idx: {daid};"
           f"\n Src Port Idx: {spid} ({pdesc(spid)});"
           f" Dst Port Idx: {dpid} ({pdesc(dpid)});")
    payload = b[ptr:]
    if len(payload):
        if spid == 1 or dpid == 1:
            out += " Text: " + _utf16(payload)
        elif spid == 2 or dpid == 2:
            from dsdneo_tpu_torch.protocol.dmr.gps import decode_lip
            out += " " + decode_lip(np.unpackbits(payload))
    return out
