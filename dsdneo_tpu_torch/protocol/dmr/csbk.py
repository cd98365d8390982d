"""DMR Control Signalling Block catalog (ETSI TS 102 361-4 Tier III +
vendor feature sets).

Decodes one CRC-valid 96-bit CSBK: Tier III grants (PV/TV/BTV/PD/TD
incl. duplex + multi-item), C_MOVE, C_ALOHA with the full syscode
site-model parse, C_AHOY service kinds, acknowledgement family,
P_MAINT/P_CLEAR/C_ACKVIT/C_RAND, the C_BCAST announcement dispatcher
(Ann-WD TSCC, call timers, vote-now/adjacent with syscode, local time,
mass registration, chan/freq, site params), preambles, Tier II
UU_V_Req/NACK/BS_Dwn_Act, gateway-identifier address labels, and the
Motorola Capacity Plus (FID 0x10) / Connect Plus (FID 0x06) vendor
CSBKs.  Reference parity: src/protocol/dmr/dmr_csbk.c (per-handler
bit offsets cited below), dmr_csbk_tables.c (grant names).

The port's own copy of ``dsdneo_tpu/protocol/dmr/csbk.py`` (numpy only), unchanged in its
logic, so both packages give the same results bit for bit.
"""

from __future__ import annotations

import numpy as np


def _f(bits, a, n) -> int:
    v = 0
    for b in bits[a:a + n]:
        v = (v << 1) | int(b)
    return v


GRANT_NAMES = {
    48: "Private Voice Channel Grant (PV_GRANT)",
    49: "Talkgroup Voice Channel Grant (TV_GRANT)",
    50: "Broadcast Voice Channel Grant (BTV_GRANT)",
    51: "Private Data Channel Grant: Single Item (PD_GRANT)",
    52: "Talkgroup Data Channel Grant: Single Item (TD_GRANT)",
    53: "Duplex Private Voice Channel Grant (PV_GRANT_DX)",
    54: "Duplex Private Data Channel Grant (PD_GRANT_DX)",
    55: "Private Data Channel Grant: Multi Item (PD_GRANT)",
    56: "Talkgroup Data Channel Grant: Multi Item (TD_GRANT)",
}

# special gateway identifier addresses (dmr_csbk.c k_dmr_gateway_ids)
GATEWAY_IDS = {
    0xFFFEC0: "PSTNI", 0xFFFEC1: "PABXI", 0xFFFEC2: "LINEI", 0xFFFEC3: "IPI",
    0xFFFEC4: "SUPLI", 0xFFFEC5: "SDMI", 0xFFFEC6: "REGI", 0xFFFEC7: "MSI",
    0xFFFEC9: "DIVERTI", 0xFFFECA: "TSI", 0xFFFECB: "DISPATI",
    0xFFFECC: "STUNI", 0xFFFECD: "AUTHI", 0xFFFECE: "GPI", 0xFFFECF: "KILLI",
    0xFFFED0: "PSTNDI", 0xFFFED1: "PABXDI", 0xFFFED2: "LINEDI",
    0xFFFED3: "DISPATDI", 0xFFFED4: "ALLMSI", 0xFFFED5: "IPDI",
    0xFFFED6: "DGNAI", 0xFFFED7: "TATTSI", 0xFFFFFD: "ALLMSIDL",
    0xFFFFFE: "ALLMSIDZ", 0xFFFFFF: "ALLMSID",
}

AHOY_SERVICE_KINDS = {
    0: "Voice Call", 1: "Voice Call", 2: "Packet Data Call",
    3: "Packet Data Call", 4: "UDT Short Data Call", 5: "UDT Short Data Call",
    6: "UDT Short Data Polling Service", 7: "Status Transport Service",
    8: "Call Diversion Service", 9: "Call Answer Service",
    10: "Full Duplex Voice Call", 11: "Full Duplex Packet Data Call",
    13: "Supplimentary Service (Stun/Revive/Kill/Auth)",
    14: "Registration/Authentication", 15: "Cancel Call Service",
}

BCAST_TYPES = {
    0: "Announce/Withdraw TSCC (Ann_WD_TSCC)",
    1: "Specify Call Timer Parameters (CallTimer_Parms)",
    2: "Vote Now Advice (Vote_Now)",
    3: "Broadcast Local Time (Local_Time)",
    4: "Mass Registration (MassReg)",
    5: "Announce Logical Channel/Frequency Relationship (Chan_Freq)",
    6: "Adjacent Site Information (Adjacent_Site)",
    7: "General Site Parameters (Gen_Site_Params)",
}

_WEEKDAYS = ("", "Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday")


def _gateway(*ids) -> str:
    out = ""
    for i in ids:
        label = GATEWAY_IDS.get(i)
        if label:
            out += f" {label};"
    return out


def _abs_freq_cdef(bits):
    """MBC CDEF appendix (bits 112+ of an aggregated MBC): absolute
    RX/TX frequency definition, CDEFTYPE 0
    (dmr_cspdu_pf0_c_bcast_parse_abs_freqs / move_resolve_freq)."""
    if len(bits) < 176:
        return None
    if _f(bits, 112, 4) != 0:          # unknown CDEFTYPE
        return None
    lpcn = _f(bits, 118, 12)
    tx = _f(bits, 130, 10) * 1_000_000 + _f(bits, 140, 13) * 125
    rx = _f(bits, 153, 10) * 1_000_000 + _f(bits, 163, 13) * 125
    return lpcn, rx, tx


def _syscode_fields(bits, at=40):
    """14-bit Tier III syscode → model/net/site/partition
    (dmr_decode_syscode + dmr_syscode_decode_model)."""
    syscode = _f(bits, at, 14)
    model = _f(bits, at, 2)
    if model == 0:
        net, site = _f(bits, at + 2, 9), _f(bits, at + 11, 3)
        model_str = "Tiny"
    elif model == 1:
        net, site = _f(bits, at + 2, 7), _f(bits, at + 9, 5)
        model_str = "Small"
    elif model == 2:
        net, site = _f(bits, at + 2, 4), _f(bits, at + 6, 8)
        model_str = "Large"
    else:
        net, site = _f(bits, at + 2, 2), _f(bits, at + 4, 10)
        model_str = "Huge"
    par = _f(bits, at + 14, 2)
    par_str = {1: "A", 2: "B", 3: "AB"}.get(par, "Res")
    return syscode, model_str, net, site, par_str


def decode_csbk(bits96: np.ndarray, ctx, hit=None, slot: int = 0,
                ms_sync: bool = False) -> str:
    """Decode one CRC-valid CSBK; returns the event detail string and
    emits grant/release events with trunk fields."""
    op = _f(bits96, 2, 6)
    fid = _f(bits96, 8, 8)
    pos = hit.pos if hit is not None else 0

    if fid == 0x10:
        t = _cap_plus(op, bits96, ctx)
        if t:
            return t
    if fid == 0x06:
        t = _con_plus(op, bits96, ctx, pos)
        if t:
            return t
    if fid == 0x68:
        t = _hytera_xpt(op, bits96, ctx, pos)
        if t:
            return t

    if 48 <= op <= 56:
        return _grant(op, bits96, ctx, pos, ms_sync)
    if op == 57:               # C_MOVE (dmr_csbk.c handle_move)
        lpcn, ts = _f(bits96, 16, 12), int(bits96[28])
        tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
        detail = ""
        if lpcn == 0xFFF:      # absolute parameters in the MBC appendix
            cdef = _abs_freq_cdef(bits96)
            if cdef is not None:
                lpcn, rx, _tx = cdef
                detail = f" RX Freq: {rx};"
                cm = getattr(ctx.state, "chan_map", None)
                if cm is not None and cm.freq(lpcn) is None:
                    cm.entries[lpcn] = float(rx)
        ctx.emit(f"       DMR Move (C_MOVE) LPCN: {lpcn:04d}; TS: {ts + 1};"
                 f" Target: {tgt}; Source: {src};", "dmr", pos,
                 tg=tgt, src=src, lpcn=lpcn, grant=lpcn not in (0, 0xFFF))
        return (f" | Move (C_MOVE) LPCN: {lpcn:04d}; TS: {ts + 1};"
                f" Target: {tgt}; Source: {src};{detail}")
    if op == 25:               # C_ALOHA (handle_aloha + syscode_print_type0)
        return _aloha(bits96, fid, ctx)
    if op == 28:               # C_AHOY
        svc_opt = _f(bits96, 16, 7)
        gi = int(bits96[25])
        kind = _f(bits96, 28, 4)
        tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
        svc = AHOY_SERVICE_KINDS.get(kind, f"Kind {kind:X}")
        return (f" | C_AHOY - {'Group' if gi else 'Private'} FID: {fid:02X}"
                f" SVC: {svc_opt:02X} {svc} Target: {tgt}; Source: {src};"
                f"{_gateway(src, tgt)}")
    if op == 30:
        return " | C_ACKVIT (Ackvitation/Authorization)"
    if op == 31:
        return " | C_RAND"
    if op in (32, 33, 34, 35):  # acknowledgement family (handle_acks)
        name = {32: "C_ACKD Outbound TSCC", 33: "C_ACKU Inbound TSCC",
                34: "P_ACKD Outbound Payload", 35: "P_ACKU Inbound Payload"}[op]
        rsp, reason = _f(bits96, 16, 7), _f(bits96, 23, 8)
        tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
        return (f" | {name}; Response: {rsp:02X}; Reason: {reason:02X};"
                f" Target: {tgt}; Source: {src};{_gateway(src, tgt)}")
    if op == 38:
        tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
        return (f" | Negative Acknowledgement Response (NACK_Rsp) -"
                f" Target [{tgt}] - Source [{src}]")
    if op == 40:               # C_BCAST
        return _c_bcast(bits96, fid, ctx, pos)
    if op == 42:               # P_MAINT
        kind = _f(bits96, 28, 3)
        tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
        k = "Disconnect; " if kind == 0 else f"Kind: {kind:02X}; "
        return (f" | P_MAINT - {k}Target: {tgt}; Source: {src};"
                f"{_gateway(src, tgt)}")
    if op == 46:               # P_CLEAR: active calls released
        ctx.emit("       DMR Clear (P_CLEAR)", "dmr", pos, release=True)
        return " | Clear (P_CLEAR)"
    if op == 61:               # Preamble CSBK
        content = "Data" if bits96[16] else "CSBK"
        gi = "Group" if bits96[17] else "Individual"
        blocks = _f(bits96, 24, 8)
        tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
        return (f" | Preamble CSBK - {content} - {gi} -"
                f" Blocks: {blocks}; Target: {tgt}; Source: {src};"
                f"{_gateway(src, tgt)}")
    if op in (4, 5, 7):        # Tier II simple
        if op == 7:
            return " | Channel Timing CSBK (CT_CSBK)"
        tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
        name = ("Unit to Unit Voice Service Request (UU_V_Req)" if op == 4
                else "Unit to Unit Voice Service Answer Response (UU_Ans_Req)")
        return f" | {name} - Target [{tgt}] - Source [{src}]"
    tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
    return f" | CSBK {op:02X} FID {fid:02X} [{tgt}] [{src}]"


def _grant(op, bits96, ctx, pos, ms_sync) -> str:
    """Tier III channel grants (handle_grants; lpcn 16:12, ts bit 28,
    emergency bit 30, target 32:24, source 56:24)."""
    if op == 56 and ms_sync:
        tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
        return (f" | BS Outbound Activation (BS_Dwn_Act) -"
                f" Target [{tgt}] - Source [{src}]")
    lpcn = _f(bits96, 16, 12)
    ts = int(bits96[28])
    emerg = int(bits96[30])
    tgt, src = _f(bits96, 32, 24), _f(bits96, 56, 24)
    ctx.state.last_tg, ctx.state.last_src = tgt, src
    name = GRANT_NAMES[op]
    data_call = op in (51, 52, 54, 55, 56)
    detail = (f" | {name}\n  LPCN: {lpcn:04d}; TS: {ts + 1};"
              f" Target: {tgt:08d} - Source: {src:08d} "
              + ("Emergency; " if emerg else "") + _gateway(src, tgt).strip())
    ctx.emit(f"       DMR {name} LPCN {lpcn} TS {ts + 1}"
             f" TG {tgt} SRC {src}", "dmr", pos, tg=tgt, src=src,
             lpcn=lpcn, slot_sel=ts, grant=lpcn not in (0, 0xFFF),
             data=data_call, private=op in (48, 53),
             emergency=bool(emerg))
    return detail


def _aloha(bits96, fid, ctx) -> str:
    syscode, model, net, site, par = _syscode_fields(bits96)
    version = _f(bits96, 19, 3)
    mask = _f(bits96, 24, 5)
    sf = _f(bits96, 29, 2)
    nrand = _f(bits96, 31, 4)
    regreq = int(bits96[35])
    backoff = _f(bits96, 36, 4)
    tgt = _f(bits96, 56, 24)
    capmax = " Capacity Max" if fid == 0x10 else ""
    s = ctx.state
    s.dmr_t3_syscode = syscode
    s.dmr_site_parms = f"TIII {model}:{net}-{site};{syscode:04X}; "
    detail = (f" | C_ALOHA_SYS_PARMS: {model}; Net ID: {net};"
              f" Site ID: {site}; Cat: {par}; SYS: {syscode:04X};{capmax}"
              f" Ver: {version}; SF: {sf}; NR: {nrand:X};"
              + (" Reg Required;" if regreq else "")
              + f" Backoff: {backoff:X};")
    if mask:
        detail += f" Mask: {mask:02X};"
    if tgt:
        detail += f" MS: {tgt};{_gateway(tgt)}"
    return detail


def _c_bcast(bits96, fid, ctx, pos) -> str:
    """C_BCAST announcement dispatcher (c_bcast_parse + per-type
    handlers; 96-bit fields only — MBC continuation carries the
    absolute-frequency CDEF)."""
    a_type = _f(bits96, 16, 5)
    bp1 = bits96[21:35]
    reg = int(bits96[35])
    backoff = _f(bits96, 36, 4)
    syscode = _f(bits96, 40, 14)
    bp2 = bits96[56:80]
    label = BCAST_TYPES.get(
        a_type, f"Reserved: {a_type:02X}" if a_type < 0x1E
        else f"Manufacturer Specific: {a_type:02X}")
    detail = f" | Announcements (C_BCAST) {label}"

    if a_type == 0:            # Ann-WD TSCC
        cc1, cc2 = _f(bp1, 4, 4), _f(bp1, 8, 4)
        add1 = "Remove" if bp1[12] else "Add"
        add2 = "Remove" if bp1[13] else "Add"
        ch1, ch2 = _f(bp2, 0, 12), _f(bp2, 12, 12)
        detail += (f"\n  LPCN CH1: {ch1}; CC: {cc1}; {add1};"
                   f" LPCN CH2: {ch2}; CC: {cc2}; {add2};")
        ctx.emit(f"       DMR C_BCAST Ann-WD TSCC CH1 {ch1} CH2 {ch2}",
                 "dmr", pos, neighbors=[c for c in (ch1, ch2) if 0 < c < 0xFFF])
    elif a_type == 1:          # call timers
        emerg_t, packet_t = _f(bp1, 0, 9), _f(bp1, 9, 5)
        msms_t, line_t = _f(bp2, 0, 12), _f(bp2, 12, 12)
        detail += (f"\n  Timers - Emergency: {emerg_t}; Packet: {packet_t};"
                   f" MS-MS: {msms_t}; Line: {line_t};")
    elif a_type in (2, 6):     # vote now / adjacent site (syscode in bparms1)
        sc, model, net, site, par = _syscode_fields(
            np.concatenate([np.zeros(40, np.uint8), np.asarray(bp1),
                            np.zeros(2, np.uint8)]), 40)
        online = "Online" if bp2[1] else "Offline"
        ccp, acp = _f(bp2, 2, 3), _f(bp2, 5, 3)
        a_chan = _f(bp2, 12, 12)
        detail += (f"\n  {model}; Net ID: {net}; Site ID: {site};"
                   f" SYS: {sc:04X};")
        if bp2[0]:
            detail += (f" {online}; CC Pri: {ccp}; AC Pri: {acp};"
                       + (f" LPCN: {a_chan};" if 0 < a_chan < 0xFFF else ""))
            if 0 < a_chan < 0xFFF:
                ctx.emit(f"       DMR Adjacent Site LPCN {a_chan}", "dmr",
                         pos, neighbors=[a_chan])
        else:
            detail += " Active Connection Information Not Available;"
    elif a_type == 3:          # local time
        day, mon = _f(bp1, 0, 5), _f(bp1, 5, 4)
        off, sign = _f(bp1, 9, 4), int(bp1[13])
        hour, mins, secs = _f(bp2, 0, 5), _f(bp2, 5, 6), _f(bp2, 11, 6)
        dofw = _f(bp2, 17, 3)
        detail += "\n "
        if mon and day:
            detail += f" Date: {mon}.{day};"
        if dofw:
            detail += f" {_WEEKDAYS[dofw]};"
        detail += f" UTC Time: {hour:02d}:{mins:02d}:{secs:02d};"
        if off != 15:
            local = hour - off if sign else hour + off
            detail += f" Local: {local:02d}:{mins:02d}:{secs:02d};"
    elif a_type == 4:          # mass registration
        window, mask = _f(bp1, 5, 4), _f(bp1, 9, 5)
        addr = _f(bp2, 16, 8)
        detail += (f"\n  Reg Window: {window:X}; Aloha Mask: {mask:02X};"
                   f" Target: {addr};")
    elif a_type == 5:          # chan/freq relationship
        a_chan = _f(bp2, 12, 12)
        detail += f"\n  LPCN: {'Null' if a_chan == 0 else a_chan};"
        # reference handle_chan_freq: a_channel 0 → no CDEF parse at
        # all, and only 0 < a_channel < 0xFFF entries are stored
        if a_chan != 0:
            cdef = _abs_freq_cdef(bits96)
            if cdef is not None:
                lpcn, rx, tx = cdef
                detail += (f" APCN: {lpcn:04d}; RX Freq: {rx};"
                           f" TX Freq: {tx};")
                cm = getattr(ctx.state, "chan_map", None)
                if (cm is not None and 0 < a_chan < 0xFFF
                        and cm.freq(a_chan) is None):
                    # learn the channel→frequency relationship
                    # (reference dmr_cspdu_pf0_c_bcast_maybe_store_channel)
                    cm.entries[a_chan] = float(rx)
    elif a_type == 7:          # general site parameters
        detail += (f"\n  Hibernate Flag: {int(bp2[1])};"
                   f" Reg Flag: {int(bp2[16])};")
    detail += (f"\n  SYS: {syscode:04X}; Reg: {reg};"
               f" Backoff: {backoff:X};")
    return detail


def _cap_plus(op, bits96, ctx) -> str:
    """Motorola Capacity Plus FID 0x10 (cap_plus handlers)."""
    if op == 0x3A:
        return " | Capacity Plus CSBK 0x3A"
    if op == 0x3B:             # adjacent sites: site/rest nibble pairs
        pairs = []
        for i in range(6):
            s_ = _f(bits96, 32 + 8 * i, 4)
            r = _f(bits96, 36 + 8 * i, 4)
            if s_:
                pairs.append(f"Site: {s_} Rest: {r};")
        ctx.state.dmr_branding = "Motorola Cap+"
        return " | Capacity Plus Adjacent Sites " + " ".join(pairs)
    if op == 0x3E:             # channel status (single-block parse)
        fl = _f(bits96, 16, 2)
        ts = int(bits96[18])
        rest = _f(bits96, 20, 4)
        kind = {0: "Appended Block", 1: "Final Block", 2: "Initial Block",
                3: "Single Block"}[fl]
        detail = (f" | Capacity Plus Channel Status - FL: {fl} TS: {ts}"
                  f" - Rest LSN: {rest} - {kind}")
        ctx.state.dmr_branding = "Motorola Cap+"
        ctx.state.dmr_rest_channel = rest
        if fl == 3:            # single block: bank-one active group LSNs
            active = [i + 1 for i in range(8) if bits96[24 + i]]
            if active:
                detail += " Active LSNs: " + " ".join(map(str, active))
        return detail
    return ""


def _con_plus(op, bits96, ctx, pos) -> str:
    """Motorola Connect Plus FID 0x06 (con_plus handlers; byte-aligned)."""
    by = [_f(bits96, i * 8, 8) for i in range(12)]
    if op == 0x01:             # adjacent sites
        nb = [by[i] & 0x3F for i in range(2, 7)]
        sites = " ".join(f"{n};" for n in nb if n) or " None Listed;"
        ctx.state.dmr_branding = "Motorola Con+"
        return f" | Connect Plus Adjacent Sites: {sites}"
    if op == 0x03:             # voice channel grant
        src = (by[2] << 16) | (by[3] << 8) | by[4]
        grp = (by[5] << 16) | (by[6] << 8) | by[7]
        lcn, ts, opt = by[8] >> 4, (by[8] >> 3) & 1, by[9]
        kind = {2: "Group", 3: "Private"}.get(opt, f"Unknown {opt:02X}")
        ctx.state.last_tg, ctx.state.last_src = grp, src
        ctx.state.dmr_branding = "Motorola Con+"
        ctx.emit(f"       DMR Connect Plus {kind} Voice Channel Grant"
                 f" LCN {lcn} TS {ts + 1} TG {grp} SRC {src}", "dmr", pos,
                 tg=grp, src=src, lpcn=lcn, slot_sel=ts, grant=lcn != 0)
        return (f" | Connect Plus {kind} Voice Channel Grant;"
                f" Target: {grp}; Source: {src}; LCN: {lcn}; TS: {ts + 1};")
    if op == 0x06:             # data channel grant
        tgt = (by[2] << 16) | (by[3] << 8) | by[4]
        lcn, ts = by[5] >> 4, (by[5] >> 3) & 1
        ctx.state.dmr_branding = "Motorola Con+"
        ctx.emit(f"       DMR Connect Plus Data Channel Grant LCN {lcn}"
                 f" TS {ts + 1} TGT {tgt}", "dmr", pos,
                 tg=tgt, lpcn=lcn, slot_sel=ts, grant=lcn != 0, data=True)
        return (f" | Connect Plus Data Channel Grant; Target: {tgt};"
                f" LCN: {lcn}; TS: {ts + 1};")
    if op == 0x0C:
        ctx.emit("       DMR Connect Plus Call Termination", "dmr", pos,
                 release=True)
        return " | Connect Plus Call Termination;"
    return ""


def _hytera_xpt(op, bits96, ctx, pos) -> str:
    """Hytera XPT FID 0x68 (dmr_csbk.c xpt handlers; the SN field lives
    in the LB/PF bit positions, so the PF gate is bypassed for these)."""
    if op == 0x0A:             # site status: free LCN + 6 LSN states
        sn = _f(bits96, 0, 2)
        free = _f(bits96, 16, 4)
        bank = sn * 6 if 0 < sn <= 2 else 0
        states = [_f(bits96, 20 + 2 * i, 2) for i in range(6)]
        tgs = [_f(bits96, 32 + 8 * i, 8) for i in range(6)]
        labels = {0: "Idle", 1: "-RES-", 2: "Private", 3: "Group"}
        parts = []
        active = []
        for i, (st_, tg) in enumerate(zip(states, tgs)):
            lsn = bank + i + 1
            parts.append(f"LSN {lsn:02d}: ST-{st_:X}"
                         + (f" {tg:03d} {labels.get(st_, '')};" if st_ else
                            " Idle;"))
            if st_ in (2, 3) and tg:
                active.append((lsn, tg, st_ == 3))
        ctx.state.dmr_branding = "Hytera XPT"
        ctx.state.dmr_site_parms = f"Free LCN - {free} "
        for lsn, tg, _group in active:
            ctx.emit(f"       DMR XPT Active LSN {lsn} TG {tg}", "dmr", pos,
                     tg=tg, lpcn=(lsn + 1) // 2, slot_sel=(lsn - 1) & 1,
                     grant=True)
        return (f" | Hytera XPT Site Status - Free LCN: {free} SN: {sn}\n  "
                + " ".join(parts))
    if op == 0x0B:             # adjacent sites
        sn = _f(bits96, 0, 2)
        sites = []
        for i in range(4):
            sid = _f(bits96, 16 + 16 * i, 5)
            rp = _f(bits96, 24 + 16 * i, 4)
            if sid:
                sites.append(f"Site:{sid} Free:{rp};")
        ctx.state.dmr_branding = "Hytera XPT"
        return (f" | Hytera XPT CSBK 0x0B - SN: {sn}\n  XPT Adjacent "
                + " ".join(sites))
    return ""
