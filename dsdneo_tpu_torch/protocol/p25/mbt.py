"""P25 multi-block trunking (AMBTC/UMBTC) PDU catalog.

Native layouts for trunking messages carried as MPDUs — the extended
forms whose fields live across the 12-byte header + data blocks and do
NOT coincide with the single-block TSBK layouts: site status
broadcasts with CHAN-T/CHAN-R, extended grants with fully-qualified
SUIDs, extended command metadata, affiliation/registration responses,
roaming addresses, inbound (ISP) requests, and the MFID90 group
regroup grant.  Reference parity:
src/protocol/p25/phase1/p25p1_pdu_trunking.c (byte offsets cited per
handler; opcode index rule :77-88 — AMBTC fmt 0x17 carries the opcode
at header byte 7, UMBTC fmt 0x15 at block byte 12).

The port's own copy of ``dsdneo_tpu/protocol/p25/mbt.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def _u16(b, i):
    return (int(b[i]) << 8) | int(b[i + 1])


def _u24(b, i):
    return (int(b[i]) << 16) | (int(b[i + 1]) << 8) | int(b[i + 2])


def _wacn(b, i, j, k):
    """20-bit WACN split across bytes i,j and the high nibble of k."""
    return (int(b[i]) << 12) | (int(b[j]) << 4) | (int(b[k]) >> 4)


def _sysid(b, i):
    return ((int(b[i]) & 0x0F) << 8) | int(b[i + 1])


def _chan_valid(ch: int) -> bool:
    return ch not in (0, 0xFFFF)


def decode_mbt(mpdu: np.ndarray, ctx, hit, decoder) -> bool:
    """Decode one assembled MPDU (header 12 bytes + blocks).  Returns
    True when handled natively; False → caller may fall back to the
    TSBK bridge for layouts that do coincide."""
    b = mpdu
    n = len(b)
    if n < 12:
        return False
    fmt = int(b[0]) & 0x1F
    outbound = bool(int(b[0]) & 0x20)
    mfid = int(b[2])
    op_idx = 7 if fmt == 0x17 else 12
    if op_idx >= n:
        return False
    op = int(b[op_idx]) & 0x3F
    pos = hit.pos

    def emit(text, **fields):
        ctx.emit(text, "p25p1", pos, **fields)

    if not outbound:
        return _inbound(op, fmt, b, n, mfid, emit)
    if mfid in (0, 1):
        return _outbound_standard(op, b, n, ctx, emit, decoder)
    if mfid == 0x90 and op == 0x00 and n >= 18:
        svc = int(b[8])
        cht, chr_ = _u16(b, 12), _u16(b, 14)
        src, grp = _u24(b, 3), _u16(b, 16)
        ctx.state.last_tg, ctx.state.last_src = grp, src
        emit(f" MFID90 Group Regroup Channel Grant - Explicit MBT\n"
             f"  RES/P [{svc:02X}] CHAN-T [{cht:04X}] CHAN-R [{chr_:04X}]"
             f" SG [{grp}][{grp:04X}]", tg=grp, src=src, channel=cht,
             grant=_chan_valid(cht))
        return True
    emit(f" MFID {mfid:02X} MBT Opcode {op:02X}")
    return True


def _outbound_standard(op, b, n, ctx, emit, decoder) -> bool:
    s = ctx.state
    if op == 0x3B and n >= 20:     # Network Status Broadcast - Extended
        lra = int(b[3])
        sysid = _sysid(b, 4)
        wacn = _wacn(b, 12, 13, 14)
        cht, chr_ = _u16(b, 15), _u16(b, 17)
        s.p2_wacn, s.p2_sysid = wacn, sysid
        emit(f" Network Status Broadcast MBT - Extended \n"
             f"  LRA [{lra:02X}] WACN [{wacn:05X}] SYSID [{sysid:03X}]"
             f" NAC [{s.p2_cc:03X}]\n  CHAN-T [{cht:04X}] CHAN-R [{chr_:04X}]",
             wacn=wacn, sysid=sysid)
        return True
    if op == 0x3A and n >= 19:     # RFSS Status Broadcast - Extended
        lra, lsysid = int(b[3]), _sysid(b, 4)
        rfss, site = int(b[12]), int(b[13])
        cht, chr_ = _u16(b, 14), _u16(b, 16)
        sysclass = int(b[18])
        s.p2_rfssid, s.p2_siteid = rfss, site
        emit(f" RFSS Status Broadcast MBT - Extended \n"
             f"  LRA [{lra:02X}] SYSID [{lsysid:03X}] RFSS [{rfss:03d}]"
             f" SITE [{site:03d}] CHAN-T [{cht:04X}] CHAN-R [{chr_:04X}]"
             f" CLASS [{sysclass:02X}]")
        return True
    if op == 0x3C and n >= 14:     # Adjacent Status Broadcast - Extended
        lra, cfva = int(b[3]), int(b[4]) >> 4
        lsysid = _sysid(b, 4)
        rfss, site = int(b[8]), int(b[9])
        cht = _u16(b, 12)
        emit(f" Adjacent Status Broadcast MBT - Extended \n"
             f"  LRA [{lra:02X}] CFVA [{cfva:X}] SYSID [{lsysid:03X}]"
             f" RFSS [{rfss:03d}] SITE [{site:03d}] CHAN-T [{cht:04X}]",
             neighbors=[cht])
        return True
    if op == 0x3E and n >= 10:     # Protection Parameter Broadcast
        emit(f" Protection Parameter Broadcast MBT - protected CC"
             f" ALGID [{int(b[9]):02X}]")
        return True
    if op == 0x33 and n >= 19:     # TDMA iden update (foreign system)
        lwacn = _wacn(b, 4, 5, 8)
        lsysid = _sysid(b, 8)
        emit(f" TDMA Identifier Update MBT - foreign system"
             f" WACN [{lwacn:05X}] SYSID [{lsysid:03X}] - not applied")
        return True
    if op == 0x00 and n >= 20:     # Group Voice Channel Grant - Extended
        svc = int(b[8])
        src = _u24(b, 3)
        cht, chr_ = _u16(b, 14), _u16(b, 16)
        grp = _u16(b, 18)
        s.last_tg, s.last_src = grp, src
        emit(f" Group Voice Channel Grant MBT - Extended\n"
             f"  SVC [{svc:02X}] CHAN-T [{cht:04X}] CHAN-R [{chr_:04X}]"
             f" Group [{grp}][{grp:04X}] Source [{src}]",
             tg=grp, src=src, channel=cht,
             grant=_chan_valid(cht), encrypted=bool(svc & 0x40))
        return True
    if op in (0x04, 0x06) and n >= 24:  # UU Voice Grant [Update] - Extended
        svc = int(b[8])
        cht = _u16(b, 22)
        chr_ = _u16(b, 24) if n >= 26 else 0xFFFF
        src, tgt = _u24(b, 3), _u24(b, 19)
        src_wacn = _wacn(b, 12, 13, 14)
        src_sys = _sysid(b, 14)
        label = ("Unit to Unit Voice Channel Grant Update"
                 if op == 0x06 else "Unit to Unit Voice Channel Grant")
        emit(f" {label} MBT - Extended\n"
             f"  SVC [{svc:02X}] CHAN-T [{cht:04X}]"
             + (f" CHAN-R [{chr_:04X}]" if chr_ != 0xFFFF else "")
             + f" Source [{src_wacn:05X}:{src_sys:03X}.{src}] Target [{tgt}]",
             src=src, channel=cht, grant=_chan_valid(cht))
        return True
    if op == 0x05 and n >= 20:     # UU Answer Request - Extended
        svc, tgt = int(b[8]), _u24(b, 3)
        src_wacn = _wacn(b, 13, 14, 15)
        src_sys = _sysid(b, 15)
        src = _u24(b, 17)
        emit(f" Unit to Unit Answer Request MBT - Extended"
             f" SVC [{svc:02X}] Target [{tgt}]"
             f" Source [{src_wacn:05X}:{src_sys:03X}.{src}]")
        return True
    if op in (0x08, 0x09) and n >= 18:  # telephone interconnect grant
        svc = int(b[8])
        chan, timer = _u16(b, 12), _u16(b, 16)
        tgt = _u24(b, 3)
        emit(f" Telephone Interconnect Channel Grant"
             f"{' Update' if op == 0x09 else ''} MBT - Explicit\n"
             f"  SVC [{svc:02X}] CHAN [{chan:04X}] Target [{tgt}]"
             f" Timer [{timer / 10.0:.1f}s]",
             channel=chan, grant=_chan_valid(chan))
        return True
    if op in (0x10, 0x11) and n >= 20:  # data channel grants (obsolete)
        kind = "Individual" if op == 0x10 else "Group"
        svc, src = int(b[8]), _u24(b, 3)
        cht, chr_ = _u16(b, 14), _u16(b, 16)
        grp = _u16(b, 18)
        emit(f" {kind} Data Channel Grant MBT - Obsolete\n"
             f"  SVC [{svc:02X}] CHAN-T [{cht:04X}] CHAN-R [{chr_:04X}]"
             f" Group [{grp}] Source [{src}]", channel=cht, data=True)
        return True
    if op in (0x18, 0x1A, 0x1C, 0x1F) and n >= 19:
        label = {0x18: "Status Update", 0x1A: "Status Query",
                 0x1C: "Message Update", 0x1F: "Call Alert"}[op]
        src_wacn = _wacn(b, 8, 9, 12)
        src_sys = _sysid(b, 12)
        src = _u24(b, 14)
        tgt = _u24(b, 3)
        d = (f" {label} MBT - Extended"
             f" FM [{src_wacn:05X}:{src_sys:03X}.{src}] TO [{tgt}]")
        if op == 0x18:
            d += f" UNIT STATUS [{int(b[17]):02X}] USER STATUS [{int(b[18]):02X}]"
        elif op == 0x1C:
            d += f" SHORT DATA [{_u16(b, 17):04X}]"
        emit(d)
        return True
    if op == 0x28 and n >= 21:     # Group Affiliation Response - Extended
        ta = _u24(b, 3)
        wacn = _wacn(b, 8, 9, 12)
        sysid = _sysid(b, 12)
        gid, aga, ga = _u16(b, 14), _u16(b, 16), _u16(b, 18)
        lg, gav = (int(b[20]) >> 7) & 1, int(b[20]) & 3
        if gav == 0:
            from dsdneo_tpu_torch.core.affiliation import table_for
            table_for(ctx).affiliate(ta, ga)
        emit(f" Group Affiliation Response MBT - Extended\n"
             f"  MFID [00] WACN [{wacn:05X}] SYSID [{sysid:03X}]"
             f" GID [{gid:04X}] LG [{lg}] GAV [{gav}] AGA [{aga}]"
             f" GA [{ga}] TA [{ta}]")
        return True
    if op == 0x2A and n >= 17:     # Group Affiliation Query - Extended
        tgt = _u24(b, 3)
        src_wacn = _wacn(b, 8, 9, 12)
        src_sys = _sysid(b, 12)
        src = _u24(b, 14)
        emit(f" Group Affiliation Query MBT - Extended Target [{tgt}]"
             f" Source [{src_wacn:05X}:{src_sys:03X}.{src}]")
        return True
    if op == 0x2C and n >= 18:     # Unit Registration Response - Extended
        src = _u24(b, 3)
        wacn = _wacn(b, 8, 9, 12)
        sysid = _sysid(b, 12)
        sid = _u24(b, 14)
        rv = int(b[17]) & 3
        verdict = {0: "REG_ACCEPT", 1: "REG_FAIL",
                   2: "REG_DENY"}.get(rv, "REG_REFUSED")
        if rv == 0:
            from dsdneo_tpu_torch.core.affiliation import table_for
            table_for(ctx).register(src)
        emit(f" Unit Registration Response MBT - Extended\n"
             f"  WACN [{wacn:05X}] SYSID [{sysid:03X}] SRC_ID [{sid:06X}]"
             f" SRC [{src}] {verdict}")
        return True
    if op in (0x36, 0x37) and n >= 17:  # Roaming Address Command/Update
        tgt = _u24(b, 3)
        final = " Final" if int(b[8]) & 0x80 else ""
        msn = int(b[8]) & 0x0F
        wacn = _wacn(b, 9, 12, 13)
        sysid = _sysid(b, 13)
        label = "Command" if op == 0x36 else "Update"
        emit(f" Roaming Address {label} MBT - Extended Target [{tgt}]"
             f" MSN [{msn}]{final} WACN [{wacn:05X}] SYSID [{sysid:03X}]")
        return True
    return False


def _inbound(op, fmt, b, n, mfid, emit) -> bool:
    """ISP (subscriber → system) MBT requests
    (p25_handle_mbt_inbound_*)."""
    if mfid == 0x90:
        if op == 0x00 and n >= 18:
            emit(f" MFID90 (Moto) Group Regroup Voice Request MBT - Inbound"
                 f" SVC [{int(b[8]):02X}] SG [{_u16(b, 16)}]"
                 f" FM [{_u24(b, 3)}]")
            return True
        if op == 0x01 and n >= 15:
            emit(f" MFID90 (Moto) Extended Function Response MBT - Inbound"
                 f" FM [{_u24(b, 3)}] FUNC [{_u16(b, 8):04X}]"
                 f" ARG [{_u24(b, 12):06X}]")
            return True
        emit(f" Inbound MBT metadata only - MFID {mfid:02X} OP {op:02X}")
        return True
    if op == 0x04 and n >= 17:
        emit(f" Unit-to-Unit Voice Service Request MBT - Inbound"
             f" SVC [{int(b[8]):02X}] FM [{_u24(b, 14)}] TO [{_u24(b, 3)}]")
        return True
    if op == 0x08 and fmt == 0x15 and n >= 13:
        digits = "".join(f"{int(b[i]):02X}" for i in range(13, min(15, n)))
        emit(f" Telephone Interconnect Explicit Dial Request UMBTC -"
             f" Inbound DIGITS [{digits}]")
        return True
    if op == 0x09 and n >= 17:
        emit(f" Telephone Interconnect PSTN Request MBT - Inbound"
             f" SVC [{int(b[8]):02X}] FM [{_u24(b, 14)}] TO [{_u24(b, 3)}]")
        return True
    if op == 0x0A and n >= 17:
        emit(f" Telephone Interconnect Answer Response MBT - Inbound"
             f" SVC [{int(b[8]):02X}] FM [{_u24(b, 14)}] TO [{_u24(b, 3)}]"
             f" RESPONSE [{int(b[9]):02X}]")
        return True
    if op == 0x32 and n >= 17:
        wacn = (int(b[3]) << 12) | (int(b[4]) << 4) | (int(b[5]) >> 4)
        sysid = _sysid(b, 5)
        emit(f" Identifier/Frequency Band Update Request MBT - Inbound"
             f" FM [{_u24(b, 14)}] WACN [{wacn:05X}] SYSID [{sysid:03X}]")
        return True
    emit(f" Inbound MBT metadata only - MFID {mfid:02X} OP {op:02X}")
    return True
