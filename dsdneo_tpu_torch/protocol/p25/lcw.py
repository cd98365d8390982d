"""P25 Link Control Word catalog (TIA-102.AABF-D formats).

Decodes the 72-bit LCW payload carried by LDU1 (and TDULC): voice
channel user/update formats, source-ID extensions, the broadcast family
(system service, secondary CC, adjacent/RFSS/network status incl. the
explicit LCxxBX forms), protection parameters, and the Motorola MFID90
opcode set (group regroup, failsoft, BSI, emergency alarm, talker
EOT/alias).  Reference parity: src/protocol/p25/p25_lcw.c:100-880
(field offsets cited per handler below).

The port's own copy of ``dsdneo_tpu/protocol/p25/lcw.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def _f(bits, a, n) -> int:
    v = 0
    for b in bits[a:a + n]:
        v = (v << 1) | int(b)
    return v


def _svc_suffix(svc: int) -> str:
    """Service-options suffix (p25_lcw.c print_service_options)."""
    out = ""
    if svc & 0x80:
        out += " Emergency"
    if svc & 0x40:
        out += " Encrypted"
    if svc & 0x20:
        out += " Duplex"
    if svc & 0x10:
        out += " Packet"
    if svc & 0x7:
        out += f" Priority {svc & 0x7}"
    return out


_SVC_FORMATS = frozenset((0x00, 0x03, 0x44, 0x45, 0x46, 0x4A))


def decode_lcw(bits: np.ndarray, hit, ctx, decoder) -> None:
    """Dispatch one 72-bit LCW.  ``decoder`` is the P25P1Decoder for
    the iden-table / channel-frequency helpers."""
    lcf = _f(bits, 0, 8)
    pf, sf = int(bits[0]), int(bits[1])
    mfid = _f(bits, 8, 8)
    s = ctx.state
    if pf:                     # protected LCW: no plaintext content
        ctx.emit(" LCW Protected", "p25p1", hit.pos)
        return
    svcopt = _f(bits, 8, 8) if lcf == 0x4A else _f(bits, 16, 8)
    suffix = _svc_suffix(svcopt) if lcf in _SVC_FORMATS else ""

    # SF=1 or MFID 0/1 → standard format; else vendor partition
    # (p25_lcw.c:1033 is_standard_mfid)
    if not (sf == 1 or mfid in (0, 1)):
        if mfid == 0x90:
            _mfid90(lcf, bits, hit, ctx)
        elif mfid == 0xA4 and lcf == 0x0A:   # Harris return-to-control
            src, tgt = _f(bits, 24, 24), _f(bits, 48, 24)
            ctx.emit(f" MFIDA4 (Harris) 0x0A Data/Return-to-Control"
                     f" Indication; SRC: {src}; TGT: {tgt};",
                     "p25p1", hit.pos)
        elif mfid == 0xA4 and lcf in (0x2A, 0x2B):
            # Harris talker GPS split over two LCWs: block 1 carries
            # the 16-bit header + first 56 GPS bits, block 2 the rest
            # (reference p25_lcw_dispatch_mfid_a4 :909-929)
            if lcf == 0x2A:
                buf = np.zeros(192, np.uint8)
                buf[0:16] = bits[0:16]
                buf[40:96] = bits[16:72]
                decoder._harris_gps = buf
                ctx.emit(" MFIDA4 (Harris) GPS Block 1", "p25p1", hit.pos)
            else:
                buf = getattr(decoder, "_harris_gps", None)
                if buf is not None and _f(buf, 0, 16) == 0x2AA4:
                    buf[96:152] = bits[16:72]
                    from dsdneo_tpu_torch.protocol.p25.harris import \
                        decode_harris_gps
                    ctx.emit(" MFIDA4 (Harris) GPS Block 2\n "
                             + decode_harris_gps(buf), "p25p1", hit.pos)
                else:
                    ctx.emit(" MFIDA4 (Harris) GPS Block 2"
                             " Missing GPS Block 1", "p25p1", hit.pos)
                decoder._harris_gps = None
        elif mfid == 0xA4 and 0x32 <= lcf <= 0x35:
            # Harris talker alias fragments (reference
            # l3h_embedded_alias_blocks_phase1)
            from dsdneo_tpu_torch.protocol.p25.harris import HarrisAliasAssembler
            asm = getattr(decoder, "_harris_alias", None)
            if asm is None:
                asm = decoder._harris_alias = HarrisAliasAssembler()
            text = asm.add(lcf, bits)
            line = " MFIDA4 (Harris) Talker Alias Blocks"
            if text:
                line += f" Talker Alias: {text}"
            ctx.emit(line, "p25p1", hit.pos)
        elif mfid == 0xD8 and lcf == 0x00:   # Tait ISO7 talker alias
            # 8 chars x 7 bits from bit 16 (reference
            # tait_iso7_embedded_alias_decode)
            chars = [_f(bits, 16 + 7 * i, 7) for i in range(8)]
            text = "".join("." if c == 0x2C else
                           chr(c) if c >= 0x20 else " " for c in chars)
            ctx.emit(f" MFIDD8 (Tait) Talker Alias: {text}",
                     "p25p1", hit.pos)
        elif mfid == 0xD8 and lcf == 0x01:   # Tait subscriber FQ-SUID
            wacn, sysid = _f(bits, 16, 20), _f(bits, 36, 12)
            src = _f(bits, 48, 24)
            ctx.emit(f" MFIDD8 (Tait) Subscriber FQ-SUID:"
                     f" {wacn:05X}.{sysid:03X}.{src}", "p25p1", hit.pos,
                     src=src)
        else:
            ctx.emit(f" LCW Unknown Format {lcf:02X} MFID {mfid:02X}",
                     "p25p1", hit.pos)
        return

    if lcf == 0x00:            # Group Voice Channel User (p25_lcw.c:178)
        group, src = _f(bits, 32, 16), _f(bits, 48, 24)
        s.last_tg, s.last_src = group, src
        ctx.emit(f" Group Voice Channel User - Group {group} Source {src}"
                 f"{suffix}", "p25p1", hit.pos, tg=group, src=src)
    elif lcf == 0x03:          # Unit to Unit Voice Channel User (:204)
        target, src = _f(bits, 24, 24), _f(bits, 48, 24)
        ctx.emit(f" Unit to Unit Voice Channel User - Target {target}"
                 f" Source {src}{suffix}", "p25p1", hit.pos, src=src)
    elif lcf == 0x42:          # Group Voice Channel Update (:214)
        ch1, g1 = _f(bits, 8, 16), _f(bits, 24, 16)
        ch2, g2 = _f(bits, 40, 16), _f(bits, 56, 16)
        line = f" Group Voice Channel Update - Ch: {ch1:04X} TG: {g1}; "
        if ch2 and ch2 != ch1:
            line += f"Ch: {ch2:04X} TG: {g2}; "
        ctx.emit(line, "p25p1", hit.pos, tg=g1, channel=ch1)
    elif lcf == 0x44:          # Group Voice Channel Update - Explicit (:333)
        g1 = _f(bits, 24, 16)
        cht, chr_ = _f(bits, 40, 16), _f(bits, 56, 16)
        ctx.emit(f" Group Voice Channel Update - Explicit"
                 f" Ch: {cht:04X} TG: {g1}; "
                 f"{decoder._chan_freq_note(ctx, cht)}",
                 "p25p1", hit.pos, tg=g1, channel=cht)
    elif lcf == 0x45:
        ctx.emit(f" Unit to Unit Answer Request{suffix}", "p25p1", hit.pos)
    elif lcf == 0x46:          # Telephone Interconnect Voice User (:357)
        timer, target = _f(bits, 32, 16), _f(bits, 48, 24)
        ctx.emit(f" Telephone Interconnect Voice Channel User -"
                 f" Target {target} Timer {timer / 10.0:.1f}s{suffix}",
                 "p25p1", hit.pos)
    elif lcf == 0x47:
        ctx.emit(" Telephone Interconnect Answer Request", "p25p1", hit.pos)
    elif lcf == 0x49:          # Source ID Extension (:379)
        wacn, sysid = _f(bits, 16, 20), _f(bits, 36, 12)
        src = _f(bits, 48, 24)
        ctx.emit(f" Source ID Extension - Full SUID: WACN {wacn:05X}"
                 f" SYSID {sysid:03X} SRC {src}", "p25p1", hit.pos, src=src)
    elif lcf == 0x4A:          # UU Voice Channel User - Extended (:412)
        target, src = _f(bits, 24, 24), _f(bits, 48, 24)
        ctx.emit(f" Unit to Unit Voice Channel User - Extended"
                 f" TGT: {target}; SRC: {src}; {suffix}", "p25p1", hit.pos,
                 src=src)
    elif lcf == 0x50:          # Group Affiliation Query (:421)
        group, src = _f(bits, 32, 16), _f(bits, 48, 24)
        ctx.emit(f" Group Affiliation Query - TG {group} SRC {src}",
                 "p25p1", hit.pos)
    elif lcf == 0x51:
        ctx.emit(" Unit Registration Command", "p25p1", hit.pos)
    elif lcf == 0x52:
        ctx.emit(" Unit Authentication Command - OBSOLETE", "p25p1", hit.pos)
    elif lcf == 0x53:
        ctx.emit(" Status Query", "p25p1", hit.pos)
    elif lcf in (0x54, 0x55):
        ctx.emit(" Status Update", "p25p1", hit.pos)
    elif lcf == 0x56:
        ctx.emit(" Call Alert", "p25p1", hit.pos)
    elif lcf == 0x57:
        ctx.emit(" Extended Function Command", "p25p1", hit.pos)
    elif lcf in (0x58, 0x59):  # Channel Identifier Update [VU] (:479,:493)
        _iden(lcf, bits, hit, ctx, decoder)
    elif lcf == 0x5A:
        ctx.emit(" Status Update - Source ID Extension Required",
                 "p25p1", hit.pos)
    elif lcf == 0x5C:
        ctx.emit(" Extended Function Command - Source ID Extension Required",
                 "p25p1", hit.pos)
    elif lcf == 0x60:          # System Service Broadcast (:519)
        rpl = _f(bits, 20, 4)
        ssa, sss = _f(bits, 24, 24), _f(bits, 48, 24)
        ctx.emit(f" System Service Broadcast RPL [{rpl:X}] SSA [{ssa:06X}]"
                 f" SSS [{sss:06X}]", "p25p1", hit.pos)
    elif lcf == 0x61:          # Secondary Control Channel Broadcast (:529)
        rfss, site = _f(bits, 8, 8), _f(bits, 16, 8)
        cha, ssca = _f(bits, 24, 16), _f(bits, 40, 8)
        chb, sscb = _f(bits, 48, 16), _f(bits, 64, 8)
        ctx.emit(f" Secondary Control Channel Broadcast - RFSS {rfss}"
                 f" Site {site} CH A {cha:04X} SSC {ssca:02X}"
                 f" CH B {chb:04X} SSC {sscb:02X}", "p25p1", hit.pos)
    elif lcf in (0x62, 0x63):  # Adjacent Site / RFSS Status (:546,:571)
        lra, sysid = _f(bits, 8, 8), _f(bits, 20, 12)
        rfss, site = _f(bits, 32, 8), _f(bits, 40, 8)
        ch, ssc = _f(bits, 48, 16), _f(bits, 64, 8)
        name = ("Adjacent Site Status Broadcast" if lcf == 0x62
                else "RFSS Status Broadcast")
        if lcf == 0x63:
            s.p2_rfssid, s.p2_siteid = rfss, site
        ctx.emit(f" {name} - LRA {lra:02X} SYS {sysid:03X} RFSS {rfss}"
                 f" Site {site} CH {ch:04X} SSC {ssc:02X}", "p25p1", hit.pos)
    elif lcf == 0x64:          # Network Status Broadcast (:587)
        wacn, sysid = _f(bits, 16, 20), _f(bits, 36, 12)
        ch, ssc = _f(bits, 48, 16), _f(bits, 64, 8)
        s.p2_wacn, s.p2_sysid = wacn, sysid
        ctx.emit(f" Network Status Broadcast - WACN {wacn:05X}"
                 f" SYS {sysid:03X} CH {ch:04X} SSC {ssc:02X}",
                 "p25p1", hit.pos, wacn=wacn, sysid=sysid)
    elif lcf == 0x65:          # Protection Parameter Broadcast (:598)
        alg, kid = _f(bits, 24, 8), _f(bits, 32, 16)
        target = _f(bits, 48, 24)
        ctx.emit(f" Protection Parameter Broadcast\n  ALGID [{alg:02X}]"
                 f" KID [{kid:04X}] Target [{target}]", "p25p1", hit.pos)
    elif lcf == 0x66:          # Secondary CC Broadcast - Explicit (:618)
        rfss, site = _f(bits, 8, 8), _f(bits, 16, 8)
        cht, chr_ = _f(bits, 24, 16), _f(bits, 40, 16)
        ssc = _f(bits, 56, 8)
        ctx.emit(f" Secondary Control Channel Broadcast - Explicit (LCSCBX)"
                 f" - RFSS {rfss} Site {site} CH-T {cht:04X} CH-R {chr_:04X}"
                 f" SSC {ssc:02X}", "p25p1", hit.pos)
    elif lcf == 0x67:          # Adjacent Site Status - Explicit (:630)
        lra, cht = _f(bits, 8, 8), _f(bits, 16, 16)
        rfss, site = _f(bits, 32, 8), _f(bits, 40, 8)
        chr_, ssc = _f(bits, 48, 16), _f(bits, 64, 8)
        ctx.emit(f" Adjacent Site Status (LCASBX) - LRA {lra:02X}"
                 f" RFSS {rfss} Site {site} CH-T {cht:04X} CH-R {chr_:04X}"
                 f" SSC {ssc:02X}", "p25p1", hit.pos)
    elif lcf == 0x68:          # RFSS Status Broadcast - Explicit (:654)
        lra, chr_ = _f(bits, 8, 8), _f(bits, 16, 16)
        rfss, site = _f(bits, 32, 8), _f(bits, 40, 8)
        cht, ssc = _f(bits, 48, 16), _f(bits, 64, 8)
        s.p2_rfssid, s.p2_siteid = rfss, site
        ctx.emit(f" RFSS Status Broadcast - Explicit (LCRSBX) - LRA {lra:02X}"
                 f" RFSS {rfss} Site {site} CH-T {cht:04X} CH-R {chr_:04X}"
                 f" SSC {ssc:02X}", "p25p1", hit.pos)
    elif lcf == 0x69:          # Network Status Broadcast - Explicit (:671)
        wacn, sysid = _f(bits, 8, 20), _f(bits, 28, 12)
        cht, chr_ = _f(bits, 40, 16), _f(bits, 56, 16)
        s.p2_wacn, s.p2_sysid = wacn, sysid
        ctx.emit(f" Network Status Broadcast - Explicit (LCNSBX)"
                 f" - WACN {wacn:05X} SYS {sysid:03X} CH-T {cht:04X}"
                 f" CH-R {chr_:04X}", "p25p1", hit.pos,
                 wacn=wacn, sysid=sysid)
    elif lcf == 0x6A:
        ctx.emit(" Conventional Fallback", "p25p1", hit.pos)
    elif lcf == 0x6B:
        ctx.emit(" Message Update - Source ID Extension Required",
                 "p25p1", hit.pos)
    elif lcf in (0x4F, 0x0F):  # Call Termination (:695)
        tgt = _f(bits, 48, 24)
        ctx.emit(f" Call Termination; TGT: {tgt};", "p25p1", hit.pos,
                 release=True)
    else:
        ctx.emit(f" LCW Unknown Format {lcf:02X} MFID {mfid:02X}",
                 "p25p1", hit.pos)


def _iden(lcf, bits, hit, ctx, decoder) -> None:
    """LCW channel identifier update [VU] (p25_lcw.c:379-405); feeds the
    shared iden table used for channel→frequency math."""
    iden = _f(bits, 8, 4)
    if lcf == 0x58:
        bw = _f(bits, 12, 9)
        sign = _f(bits, 21, 1)
        raw = _f(bits, 22, 8)
        label = ""
    else:
        bw = _f(bits, 12, 4)
        sign = _f(bits, 16, 1)
        raw = _f(bits, 17, 13)
        label = " VU"
    trans_off = raw if sign else -raw
    chan_spac = _f(bits, 30, 10)
    base = _f(bits, 40, 32)
    decoder._iden_table(ctx).add(iden, base * 5.0, chan_spac * 125.0,
                                 trans_off * 250e3, 1)
    ctx.emit(f" Channel Identifier Update{label}; Iden: {iden:X}; BW: {bw:X};"
             f" TX Offset: {trans_off}; Spacing: {chan_spac:X};"
             f" Base: {base * 5};", "p25p1", hit.pos, iden=iden)


def _mfid90(op, bits, hit, ctx, s=None) -> None:
    """Motorola MFID90 LCW opcodes (p25_lcw.c:742-880)."""
    s = ctx.state
    if op == 0x00:             # Group Regroup Channel User (LCGRGR)
        sg, src = _f(bits, 32, 16), _f(bits, 48, 24)
        s.last_tg, s.last_src = sg, src
        ctx.emit(f" MFID90 (Moto) Group Regroup Channel User (LCGRGR)"
                 f" SG: {sg}; SRC: {src};", "p25p1", hit.pos, tg=sg, src=src)
    elif op == 0x01:           # Group Regroup Channel Update (LCGRGU)
        sg, ch = _f(bits, 24, 16), _f(bits, 56, 16)
        ctx.emit(f" MFID90 (Moto) Group Regroup Channel Update (LCGRGU)"
                 f" SG: {sg}; CH: {ch:04X};", "p25p1", hit.pos,
                 tg=sg, channel=ch)
    elif op == 0x02:           # Failsoft
        data = " ".join(f"{_f(bits, bi, 8):02X}" for bi in range(16, 72, 8))
        ctx.emit(f" MFID90 (Moto) Failsoft Data: {data}", "p25p1", hit.pos)
    elif op in (0x03, 0x04):   # Group Regroup Add / Delete
        sg = _f(bits, 16, 16)
        ga1, ga2 = _f(bits, 32, 16), _f(bits, 48, 16)
        act = "Add" if op == 0x03 else "Delete"
        from dsdneo_tpu_torch.core.affiliation import table_for
        for ga in (ga1, ga2):
            if ga not in (0, sg):
                if op == 0x03:
                    table_for(ctx).patch_add_wgid(sg, ga)
                else:
                    # reference p25_patch_remove_wgid: named WGIDs only
                    table_for(ctx).patch_remove_wgid(sg, ga)
        line = f" MFID90 (Moto) Group Regroup {act} SG: {sg};"
        if ga1 not in (0, sg):
            line += f" GA1: {ga1};"
        if ga2 not in (0, sg, ga1):
            line += f" GA2: {ga2};"
        ctx.emit(line, "p25p1", hit.pos)
    elif op == 0x05:           # System Information (BSI)
        data = " ".join(f"{_f(bits, bi, 8):02X}" for bi in range(16, 72, 8))
        ctx.emit(f" MFID90 (Moto) System Information (BSI) Data: {data}",
                 "p25p1", hit.pos)
    elif op == 0x06:           # APX embedded GPS (dsd_gps.c
        # apx_embedded_gps: lat 0-90 deg x sign, lon 0-180 deg with
        # the west hemisphere encoded as a -180 offset)
        lat = _f(bits, 25, 23) * (90.0 / 0x7FFFFF)
        lon = _f(bits, 49, 23) * (180.0 / 0x7FFFFF)
        latstr, lonstr = "N", "E"
        if bits[24]:
            lat, latstr = -lat, "S"
        if bits[48]:
            lon, lonstr = lon - 180.0, "W"
        if abs(lat) > 90.0 or abs(lon) > 180.0:
            return
        line = (f" MFID90 (Moto) GPS: Lat: {lat:.5f}{latstr}"
                f" Lon: {lon:.5f}{lonstr} ({lat:.5f}, {lon:.5f})")
        line += " Last Fix;" if bits[23] else " Current Fix;"
        ctx.emit(line, "p25p1", hit.pos)
    elif op == 0x0A:           # Emergency Alarm Activation
        group, src = _f(bits, 32, 16), _f(bits, 48, 24)
        ctx.emit(f" MFID90 (Moto) Emergency Alarm Activation"
                 f" Group: {group} Source: {src}; ** EMERGENCY **",
                 "p25p1", hit.pos, tg=group, src=src, emergency=True)
    elif op == 0x0F:           # Talker EOT
        src = _f(bits, 48, 24)
        ctx.emit(f" MFID90 (Moto) Talker EOT; SRC: {src};", "p25p1", hit.pos,
                 release=True)
    elif op == 0x15:
        ctx.emit(" MFID90 (Moto) Talker Alias Header", "p25p1", hit.pos)
    elif op == 0x17:
        ctx.emit(" MFID90 (Moto) Talker Alias Blocks", "p25p1", hit.pos)
    else:
        ctx.emit(f" MFID90 (Moto) LCW OP {op:02X}", "p25p1", hit.pos)
