"""P25 Phase 2 MAC message catalog: the native Phase 2 layouts.

The port's own copy of ``dsdneo_tpu/protocol/p25/p2_mac.py``.  Walks
the MAC content of SACCH/FACCH/LCCH PDUs and decodes the TIA-102.AABC
Phase 2 structures whose layouts differ from the Phase 1 TSBK forms:
explicit grants carrying CHAN-T/CHAN-R pairs, extended (VCH/LCCH)
messages with fully-qualified SUIDs, the vendor partitions (Motorola
MFID90 group-regroup family, L3Harris grants/GPS, Tait), and the
multi-fragment extended-LCCH messages reassembled across PDUs via
continuation opcode 0x10.  Broadcast-family messages whose octet layouts
coincide with the Phase 1 TSBK forms bridge into the TSBK catalog
(``protocol.p25.phase1``; reference tsbk_build_mac_like_pdu shows the
two layouts coincide with the MFID stripped), which also reads the
reason and function tables kept here.

Reference parity: src/protocol/p25/phase2/p25p2_vpdu.c (per-handler
layouts cited below), p25p2_mac_parse.c:42-200 (segment length
resolution), p25p2_mac_tables.c (length tables, mirrored in
mac_tables.py).
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.p25.mac_tables import mac_msg_len

# ---------------------------------------------------------------- helpers

def _u16(m, i) -> int:
    return (int(m[i]) << 8) | int(m[i + 1])


def _u24(m, i) -> int:
    return (int(m[i]) << 16) | (int(m[i + 1]) << 8) | int(m[i + 2])


def _wacn(m, i) -> int:
    """20-bit WACN of a fully-qualified SUID (vpdu fqid_wacn)."""
    return (int(m[i]) << 12) | (int(m[i + 1]) << 4) | ((int(m[i + 2]) & 0xF0) >> 4)


def _sysid(m, i) -> int:
    return ((int(m[i + 2]) & 0x0F) << 8) | int(m[i + 3])


def _suid(m, i) -> str:
    return f"{_wacn(m, i):05X}:{_sysid(m, i):03X}"


def _chan_valid(ch: int) -> bool:
    """Filler channels 0/0xFFFF never dispatch a grant (reference
    p25p2_vpdu_channel_is_valid)."""
    return ch not in (0, 0xFFFF)


# reference p25_response_reason.c tables
_DENY_REASONS = {
    0x10: "Requesting Unit Not Valid", 0x11: "Requesting Unit Not Authorized",
    0x20: "Target Unit Not Valid", 0x21: "Target Unit Not Authorized",
    0x2F: "Target Unit Refused Call", 0x30: "Target Group Not Valid",
    0x31: "Target Group Not Authorized", 0x40: "Invalid Dialing",
    0x41: "Telephone Number Not Authorized", 0x42: "PSTN Not Valid",
    0x50: "Call Timeout", 0x51: "Landline Terminated Call",
    0x52: "Subscriber Unit Terminated Call", 0x5F: "Call Preempted",
    0x60: "Site Access Denial", 0x67: "PTT Collide", 0x77: "PTT Bonk",
    0xF0: "Call Options Not Valid For Service",
    0xF1: "Protection Service Option Not Valid",
    0xF2: "Duplex Service Option Not Valid",
    0xF3: "Circuit/Packet Mode Option Not Valid",
    0xFF: "System Does Not Support Service",
}

_QUEUED_REASONS = {
    0x10: "Requesting Unit Busy Other Service",
    0x20: "Target Unit Busy Other Service",
    0x2F: "Target Unit Queued This Call",
    0x30: "Target Group Currently Active",
    0x40: "Channel Resources Unavailable",
    0x41: "Telephone Resources Unavailable",
    0x42: "Data Resources Unavailable",
    0x50: "Superseding Service Currently Active",
}

_EXT_FUNC_CLASS0 = {
    0x00: "Radio Check", 0x7D: "Radio Inhibit", 0x7E: "Radio Uninhibit",
    0x7F: "Radio Unit Detach",
}

# Standard multi-fragment base opcodes (extended LCCH structures that
# exceed one xCCH; vpdu p25p2_vpdu_is_standard_multifragment_base)
_MULTIFRAG_BASES = frozenset(
    (0x71, 0xF1, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF, 0xD9, 0xDB, 0xDE, 0xE0))

# Abbreviated messages whose layout coincides with the Phase 1 TSBK
# body (opcode & 0x3F), dispatched through the shared TSBK parsers.
_TSBK_BRIDGE = frozenset(
    (0x54, 0x55, 0x56, 0x61, 0x64, 0x68, 0x6C, 0x6D, 0x70, 0x73, 0x74,
     0x75, 0x78, 0x79, 0x7A, 0x7B, 0x7C, 0x7D))


class MacFragment:
    """Per-slot multi-fragment reassembly (vpdu consume_multifragment_*).

    ``data[0]`` is the data-length octet itself, payload follows — the
    same indexing the reference's frag_u8 handlers use."""

    def __init__(self):
        self.active = False
        self.opcode = 0
        self.data_len = 0
        self.data: list[int] = []

    def clear(self):
        self.active = False
        self.opcode = 0
        self.data_len = 0
        self.data = []

    def u8(self, i):
        return self.data[i] if 0 <= i < len(self.data) else 0

    def u16(self, i):
        return (self.u8(i) << 8) | self.u8(i + 1)

    def u24(self, i):
        return (self.u8(i) << 16) | (self.u8(i + 1) << 8) | self.u8(i + 2)

    def wacn(self, i):
        return (self.u8(i) << 12) | (self.u8(i + 1) << 4) | ((self.u8(i + 2) & 0xF0) >> 4)

    def sysid(self, i):
        return ((self.u8(i + 2) & 0x0F) << 8) | self.u8(i + 3)

    def suid(self, i):
        return f"{self.wacn(i):05X}:{self.sysid(i):03X}"

    def chan(self, i):
        # a channel field IS a big-endian u16 (band nibble + 12-bit
        # number); kept as a named accessor for the call sites' intent
        return self.u16(i)

    def has(self, n):
        return len(self.data) >= n


class P2MacWalker:
    """Message walk over one MAC PDU's octets.

    ``mac`` is the PDU octet array with the MAC header octet at index 0
    and message content from index 1 (so a reference ``MAC[k+len_a]``
    with the opcode at index 1 maps to ``msg[k-1]`` of the per-message
    slice here)."""

    def __init__(self, p1_bridge_factory):
        self._p1_factory = p1_bridge_factory
        self._p1 = None
        self.frag = {0: MacFragment(), 1: MacFragment()}

    # -- length resolution (p25p2_mac_parse.c:109-170) --------------------
    @staticmethod
    def segment_len(mac, i, n_oct) -> int:
        op = int(mac[i])
        nxt = int(mac[i + 1]) if i + 1 < n_oct else 0
        if op in (0x08, 0x10):          # length-coded TDMA structures
            return nxt & 0x3F
        if 0x80 <= op <= 0xBF:          # vendor partition: MFID at +1
            ln = mac_msg_len(op, nxt)
            if ln:
                return ln
            if op == 0xBF:
                len_octet = int(mac[i + 2]) & 0x3F if i + 2 < n_oct else 0
                return len_octet if len_octet > 0 else 3
            return int(mac[i + 2]) & 0x3F if i + 2 < n_oct else 0
        return mac_msg_len(op)

    def walk(self, mac, n_oct: int, slot: int, ctx, hit) -> str:
        out = []
        i = 1
        while i < n_oct:
            op = int(mac[i])
            if op == 0x00:
                break
            length = self.segment_len(mac, i, n_oct)
            if length <= 0:
                break
            length = min(length, n_oct - i)
            msg = [int(mac[j]) if j < n_oct else 0
                   for j in range(i, i + max(length, 19))]
            text = self._dispatch(op, msg, length, slot, ctx, hit)
            if text:
                out.append(text)
            i += length
        return "".join(out)

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, op, m, length, slot, ctx, hit) -> str:
        frag = self.frag[slot & 1]
        if op in _MULTIFRAG_BASES:
            return self._frag_base(op, m, length, slot, ctx, hit)
        if op == 0x10:
            return self._frag_cont(m, length, slot, ctx, hit)
        if op == 0x08:                  # Null Avoid Zero Bias: keep frag
            return "\n Null Information (Avoid Zero Bias)"
        if frag.active:                 # any other opcode aborts assembly
            frag.clear()

        if 0x80 <= op <= 0xBF:
            return self._vendor(op, m, length, slot, ctx, hit)
        if op in _TSBK_BRIDGE:
            self._bridge_tsbk(op, m, ctx, hit)
            return ""

        h = _STANDARD_HANDLERS.get(op)
        if h is not None:
            return h(self, op, m, slot, ctx, hit)
        if op == 0x5D:        # reference p25p2_vpdu.c:4698
            return "\n Radio Unit Monitor Command - Obsolete"
        return f"\n MAC OP {op:02X} len {length}"

    def _p1_decoder(self):
        if self._p1 is None:
            self._p1 = self._p1_factory()
        return self._p1

    def _bridge_tsbk(self, op, m, ctx, hit) -> None:
        """Rebuild the TSBK 12-byte body (MFID stripped) and reuse the
        Phase 1 field parsers (reference tsbk_build_mac_like_pdu)."""
        pseudo = np.zeros(12, dtype=np.int64)
        pseudo[0] = op & 0x3F
        for k in range(2, 12):
            pseudo[k] = m[k - 1] if k - 1 < len(m) else 0
        b96 = np.zeros(96, dtype=np.uint8)
        for bi in range(96):
            b96[bi] = (int(pseudo[bi // 8]) >> (7 - bi % 8)) & 1
        self._p1_decoder()._tsbk(b96, hit, ctx)

    # -- grants (feed the trunk SM via event fields) ----------------------
    def _grant_event(self, ctx, hit, name, detail, tg=0, src=0, channel=0):
        ctx.emit(f"       P25p2 MAC{name}{detail}", "p25p2", hit.pos,
                 tg=tg, src=src, channel=channel,
                 grant=_chan_valid(channel))
        return f"\n {name.strip()}{detail}"

    # ---- standard abbreviated / explicit / extended handlers ------------
    def _h_grp_grant(self, op, m, slot, ctx, hit):
        """0x40 abbreviated (vpdu iter_block_04)."""
        svc, chan, grp, src = m[1], _u16(m, 2), _u16(m, 4), _u24(m, 6)
        ctx.state.last_tg, ctx.state.last_src = grp, src
        return self._grant_event(
            ctx, hit, " Group Voice Channel Grant",
            f"\n  SVC [{svc:02X}] CHAN [{chan:04X}] Group [{grp}] Source [{src}]",
            tg=grp, src=src, channel=chan)

    def _h_grp_grant_explicit(self, op, m, slot, ctx, hit):
        """0xC0 grant / 0xC3 update, explicit CHAN-T/CHAN-R
        (vpdu iter_block_09/10)."""
        svc = m[1]
        cht, chr_, grp = _u16(m, 2), _u16(m, 4), _u16(m, 6)
        src = _u24(m, 8) if op == 0xC0 else 0
        name = (" Group Voice Channel Grant - Explicit" if op == 0xC0
                else " Group Voice Channel Grant Update - Explicit")
        if op == 0xC0:
            ctx.state.last_tg, ctx.state.last_src = grp, src
        d = (f"\n  SVC [{svc:02X}] CHAN-T [{cht:04X}] CHAN-R [{chr_:04X}]"
             f" Group [{grp}][{grp:04X}]")
        if src:
            d += f" Source [{src}]"
        return self._grant_event(ctx, hit, name, d, tg=grp, src=src, channel=cht)

    def _h_grp_update_explicit_abbrev(self, op, m, slot, ctx, hit):
        """0x43 (vpdu iter_block_09, 0x43 arm)."""
        svc, res = m[1], m[2]
        cht, chr_, grp = _u16(m, 3), _u16(m, 5), _u16(m, 7)
        return self._grant_event(
            ctx, hit, " Group Voice Channel Grant Update - Explicit",
            f"\n  SVC [{svc:02X}] RES [{res:02X}] CHAN-T [{cht:04X}]"
            f" CHAN-R [{chr_:04X}] Group [{grp}][{grp:04X}]",
            tg=grp, channel=cht)

    def _h_grp_update_implicit(self, op, m, slot, ctx, hit):
        """0x42 two-channel update (vpdu iter_block_05 region)."""
        ch1, g1, ch2, g2 = _u16(m, 1), _u16(m, 3), _u16(m, 5), _u16(m, 7)
        t = self._grant_event(
            ctx, hit, " Group Voice Channel Grant Update - Implicit",
            f"\n  Channel 1 [{ch1:04X}] Group 1 [{g1}][{g1:04X}]",
            tg=g1, channel=ch1 if _chan_valid(ch1) else 0)
        if ch2 != ch1 and _chan_valid(ch2):
            t += self._grant_event(
                ctx, hit, " Group Voice Channel Grant Update - Implicit",
                f"\n  Channel 2 [{ch2:04X}] Group 2 [{g2}][{g2:04X}]",
                tg=g2, channel=ch2)
        return t

    def _h_uu_grant(self, op, m, slot, ctx, hit):
        """0x44 grant / 0x46 update abbreviated
        (vpdu handle_unit_to_unit_grant_abbreviated)."""
        chan, tgt, src = _u16(m, 1), _u24(m, 3), _u24(m, 6)
        name = " Unit to Unit Channel Grant" + (" Update" if op == 0x46 else "")
        return self._grant_event(
            ctx, hit, name,
            f"\n  CHAN: {chan:04X}; SRC: {src}; TGT: {tgt}; ",
            src=src, channel=chan)

    def _h_uu_grant_extended(self, op, m, slot, ctx, hit):
        """0xC4 service / 0xC6 update extended with source SUID
        (vpdu handle_unit_to_unit_grant_extended)."""
        cht, chr_ = _u16(m, 1), _u16(m, 3)
        src, tgt = _u24(m, 9), _u24(m, 12)
        name = (" Unit to Unit Channel Grant "
                + ("Update" if op == 0xC6 else "Service") + " Extended")
        return self._grant_event(
            ctx, hit, name,
            f"\n  CHAN-T: {cht:04X}; CHAN-R: {chr_:04X};"
            f" SRC: {_suid(m, 5)}.{src}; TGT: {tgt}; ",
            src=src, channel=cht)

    def _h_uu_answer_req(self, op, m, slot, ctx, hit):
        """0x45 abbreviated / 0xC5 extended (vpdu handle_unit_to_unit_answer_request)."""
        svc, tgt = m[1], _u24(m, 2)
        if op == 0xC5:
            src = _u24(m, 9)
            return (f"\n Unit-to-Unit Answer Request - Extended"
                    f"\n  SVC [{svc:02X}] Target [{tgt}]"
                    f" Source [{_suid(m, 5)}.{src}]")
        src = _u24(m, 5)
        return (f"\n Unit-to-Unit Answer Request - Abbreviated"
                f"\n  SVC [{svc:02X}] Target [{tgt}] Source [{src}]")

    def _h_grp_service_req(self, op, m, slot, ctx, hit):
        """0x41 (vpdu handle_group_voice_service_request)."""
        svc, grp, src = m[1], _u16(m, 2), _u24(m, 4)
        return (f"\n Group Voice Service Request"
                f"\n  SVC [{svc:02X}] Group [{grp}][{grp:04X}] Source [{src}]")

    def _h_tele_voice_user(self, op, m, slot, ctx, hit):
        """0x03 (vpdu handle_telephone_interconnect_voice_user)."""
        svc, timer, tgt = m[1], _u16(m, 2), _u24(m, 4)
        return (f"\n Telephone Interconnect Voice Channel User"
                f"\n  SVC [{svc:02X}] Target [{tgt}] Timer [{timer / 10.0:.1f}s]")

    def _h_tele_answer_req(self, op, m, slot, ctx, hit):
        """0x4A BCD digits (vpdu handle_telephone_interconnect_answer_request)."""
        digits = "".join(f"{m[b]:02X}" for b in range(1, 6))
        tgt = (m[6] >> 4) & 0x0F
        return (f"\n Telephone Interconnect Answer Request"
                f"\n  Target [{tgt}] Digits [{digits}]")

    def _h_status_update(self, op, m, slot, ctx, hit):
        """0x58 abbreviated / 0xD8 extended VCH."""
        unit, user, tgt = m[2], m[3], _u24(m, 4)
        if op == 0xD8:
            src = _u24(m, 11)
            return (f"\n Status Update - Extended VCH"
                    f"\n  Target [{tgt}] Source [{_suid(m, 7)}.{src}]"
                    f" Unit [{unit:02X}] User [{user:02X}]")
        src = _u24(m, 7)
        return (f"\n Status Update - Abbreviated"
                f"\n  Target [{tgt}] Source [{src}]"
                f" Unit [{unit:02X}] User [{user:02X}]")

    _QUERY_LABELS = {0x5A: "Status Query", 0xDA: "Status Query",
                     0x5F: "Call Alert", 0xDF: "Call Alert",
                     0x6A: "Group Affiliation Query",
                     0xEA: "Group Affiliation Query"}

    def _h_query_alert(self, op, m, slot, ctx, hit):
        """0x5A/0x5F/0x6A abbreviated; 0xDA/0xDF/0xEA extended VCH
        (vpdu handle_query_alert_affiliation_*)."""
        label = self._QUERY_LABELS[op]
        tgt = _u24(m, 1)
        if op >= 0xC0:
            src = _u24(m, 8)
            return (f"\n {label} - Extended VCH"
                    f"\n  Target [{tgt}] Source [{_suid(m, 4)}.{src}]")
        src = _u24(m, 4)
        return f"\n {label} - Abbreviated\n  Target [{tgt}] Source [{src}]"

    def _h_message_update(self, op, m, slot, ctx, hit):
        """0x5C abbreviated / 0xDC extended VCH."""
        msg, tgt = _u16(m, 2), _u24(m, 4)
        if op == 0xDC:
            src = _u24(m, 11)
            return (f"\n Message Update - Extended VCH"
                    f"\n  Target [{tgt}] Source [{_suid(m, 7)}.{src}]"
                    f" Message [{msg:04X}]")
        src = _u24(m, 7)
        return (f"\n Message Update - Abbreviated"
                f"\n  Target [{tgt}] Source [{src}] Message [{msg:04X}]")

    def _h_ack_response(self, op, m, slot, ctx, hit):
        """0x60 (vpdu handle_ack_response_fne_abbreviated)."""
        addl, ext = m[1] & 0x80, m[1] & 0x40
        svc, tgt = m[1] & 0x3F, _u24(m, 6)
        d = f"\n Acknowledge Response FNE - Abbreviated\n  Service [{svc:02X}] Target [{tgt}]"
        if addl and ext:
            d += f" FQTarget [{_suid(m, 2)}.{tgt}]"
        elif addl:
            d += f" Source [{_u24(m, 3)}]"
        return d

    def _h_rum(self, op, m, slot, ctx, hit):
        """0x4C abbreviated / 0xCC extended VCH radio unit monitor."""
        time_, flags = m[2], m[3]
        silent = " Silent" if flags & 0x80 else ""
        mult, tgt = flags & 3, _u24(m, 4)
        if op == 0xCC:
            src = _u24(m, 11)
            return (f"\n Radio Unit Monitor Command - Extended VCH"
                    f"\n  Target [{tgt}] Source [{_suid(m, 7)}.{src}]"
                    f" Time [{time_}] Mult [{mult}]{silent}")
        src = _u24(m, 7)
        return (f"\n Radio Unit Monitor Command - Abbreviated"
                f"\n  Target [{tgt}] Source [{src}] Time [{time_}] Mult [{mult}]{silent}")

    def _h_rum_enhanced(self, op, m, slot, ctx, hit):
        """0x5E (vpdu handle_radio_unit_monitor_enhanced_abbreviated)."""
        tgt, grp, src = _u24(m, 1), _u16(m, 4), _u24(m, 6)
        flags, time_ = m[9], m[10]
        kid, alg = _u16(m, 11), m[13]
        tg_mode = bool(flags & 0x40)
        mon = grp if tg_mode else src
        return (f"\n Radio Unit Monitor Enhanced Command - Abbreviated"
                f"\n  Target [{tgt}] {'Group' if tg_mode else 'Source'} [{mon}]"
                f" Time [{time_}] ALG [{alg:02X}] KID [{kid:04X}]"
                f"{' Silent' if flags & 0x80 else ''}")

    def _h_roaming_cmd(self, op, m, slot, ctx, hit):
        """0x76 (vpdu handle_roaming_address_command)."""
        stack_op, tgt = m[2], _u24(m, 7)
        return (f"\n Roaming Address Command"
                f"\n  StackOp [{stack_op:02X}] Target [{_suid(m, 3)}.{tgt}]")

    def _h_roaming_update(self, op, m, slot, ctx, hit):
        """0x77 (vpdu handle_roaming_address_update)."""
        last = " Last" if m[2] & 0x80 else ""
        seq, tgt, src = m[2] & 0x0F, _u24(m, 3), _u24(m, 10)
        return (f"\n Roaming Address Update"
                f"\n  Target [{tgt}] Source [{_suid(m, 6)}.{src}] Seq [{seq}]{last}")

    def _h_ext_func_extended(self, op, m, slot, ctx, hit):
        """0xE4 extended VCH / 0xE5 extended LCCH
        (vpdu handle_extended_function_extended_*)."""
        func = _u16(m, 2)
        cls, operand = (func >> 8) & 0xFF, func & 0xFF
        arg, tgt = _u24(m, 4), _u24(m, 7)
        kind = "VCH" if op == 0xE4 else "LCCH"
        d = (f"\n Extended Function Command - Extended {kind}"
             f"\n  Class [{cls:02X}] Operand [{operand:02X}] Arg [{arg:06X}]"
             f" Target [{tgt}]")
        if op == 0xE4:
            d += f" Source [{_suid(m, 10)}.{_u24(m, 14)}]"
        else:
            d += f" Source [{_suid(m, 10)}]"
        if cls == 0 and operand in _EXT_FUNC_CLASS0:
            d += f" {_EXT_FUNC_CLASS0[operand]}"
        return d

    def _h_grp_aff_rsp_extended(self, op, m, slot, ctx, hit):
        """0xE8 (vpdu handle_group_affiliation_response_extended)."""
        local, rsp = (m[2] >> 7) & 1, m[2] & 3
        aga, ga = _u16(m, 3), _u16(m, 5)
        sgid, tgt = _u16(m, 11), _u24(m, 13)
        if rsp == 0:
            from dsdneo_tpu_torch.core.affiliation import table_for
            table_for(ctx).affiliate(tgt, ga)
        return (f"\n Group Affiliation Response - Extended"
                f"\n  LG [{local}] Response [{rsp}] AGA [{aga}] GA [{ga}]"
                f" SourceGID [{_suid(m, 7)}.{sgid}] Target [{tgt}]")

    def _h_std_regroup_voice(self, op, m, slot, ctx, hit):
        """0x30 (vpdu handle_standard_group_regroup_voice_user_abbreviated)."""
        sg, src = _u16(m, 2), _u24(m, 4)
        ctx.state.last_tg, ctx.state.last_src = sg, src
        return (f"\n VCH {(slot & 1) + 1} - Super Group {sg} SRC {src}"
                f" Standard Group Regroup Voice")

    # ---- vendor partition (0x80-0xBF; MFID at msg[1]) -------------------
    def _vendor(self, op, m, length, slot, ctx, hit) -> str:
        mfid = m[1]
        if mfid == 0x90:
            return self._vendor_moto(op, m, length, slot, ctx, hit)
        if mfid == 0xA4:
            return self._vendor_harris(op, m, length, slot, ctx, hit)
        if mfid == 0xD8:
            return self._vendor_tait(op, m, length, slot, ctx, hit)
        return f"\n MFID {mfid:02X} OP {op:02X} len {length}"

    def _vendor_moto(self, op, m, length, slot, ctx, hit) -> str:
        """Motorola MFID90 (vpdu dispatch_motorola_vendor handlers)."""
        if op == 0xA3:       # Group Regroup Channel Grant - Implicit
            svc, chan = m[3], _u16(m, 4)
            sg, src = _u16(m, 6), _u24(m, 8)
            ctx.state.last_tg, ctx.state.last_src = sg, src
            return self._grant_event(
                ctx, hit, " MFID90 Group Regroup Channel Grant - Implicit",
                f"\n  SVC [{svc:02X}] CHAN [{chan:04X}] Group [{sg}][{sg:04X}]"
                f" Source [{src}]", tg=sg, src=src, channel=chan)
        if op == 0xA4:       # Group Regroup Channel Grant - Explicit
            svc, cht, chr_ = m[3], _u16(m, 4), _u16(m, 6)
            sg, src = _u16(m, 8), _u24(m, 10)
            ctx.state.last_tg, ctx.state.last_src = sg, src
            return self._grant_event(
                ctx, hit, " MFID90 Group Regroup Channel Grant - Explicit",
                f"\n  SVC [{svc:02X}] CHAN-T [{cht:04X}] CHAN-R [{chr_:04X}]"
                f" Group [{sg}][{sg:04X}] Source [{src}]",
                tg=sg, src=src, channel=cht)
        if op == 0xA5:       # Group Regroup Channel Grant Update
            ch1, g1, ch2, g2 = _u16(m, 3), _u16(m, 5), _u16(m, 7), _u16(m, 9)
            t = self._grant_event(
                ctx, hit, " MFID90 Group Regroup Channel Grant Update",
                f"\n  Channel 1 [{ch1:04X}] Group 1 [{g1}][{g1:04X}]",
                tg=g1, channel=ch1 if _chan_valid(ch1) else 0)
            if ch2 != ch1 and _chan_valid(ch2):
                t += self._grant_event(
                    ctx, hit, " MFID90 Group Regroup Channel Grant Update",
                    f"\n  Channel 2 [{ch2:04X}] Group 2 [{g2}][{g2:04X}]",
                    tg=g2, channel=ch2)
            return t
        if op in (0xA6, 0xA7):   # Queued / Deny Response
            is_deny = op == 0xA7
            has_addl = bool(m[3] & 0x80)
            svc, reason = m[3] & 0x3F, m[4]
            addl, tgt = _u24(m, 5), _u24(m, 8)
            reasons = _DENY_REASONS if is_deny else _QUEUED_REASONS
            label = reasons.get(reason, f"{reason:02X}")
            d = (f"\n Motorola {'Deny' if is_deny else 'Queued'} Response"
                 f"\n  SVC [{svc:02X}] Reason [{label}]")
            if has_addl:
                d += f" Addl [{addl:06X}]"
            d += f" Target [{tgt}]"
            ctx.emit(f"       P25p2 MAC{d}", "p25p2", hit.pos,
                     release=True, deny=is_deny)
            return d
        if op == 0xA8:       # Acknowledge Response
            svc, src, tgt = m[3] & 0x3F, _u24(m, 4), _u24(m, 7)
            return (f"\n Motorola Acknowledge Response"
                    f"\n  Service [{svc:02X}] Source [{src}] Target [{tgt}]")
        if op == 0x84:       # Group Regroup Extended Function
            func = _u16(m, 3)
            cls, operand = (func >> 8) & 0xFF, func & 0xFF
            arg, tgt = _u24(m, 5), _u24(m, 8)
            d = (f"\n Motorola Group Regroup Extended Function Command"
                 f"\n  Class [{cls:02X}] Operand [{operand:02X}]"
                 f" Arg [{arg:06X}] Target [{tgt}]")
            from dsdneo_tpu_torch.core.affiliation import table_for
            if cls == 0x02 and operand == 0x00:
                d += f" Create Supergroup [{arg & 0xFFFF}]"
                sg = arg & 0xFFFF
                table_for(ctx).patch_update(sg)
                if tgt:
                    table_for(ctx).patch_add_wuid(sg, tgt)
            elif cls == 0x02 and operand == 0x01:
                d += f" Cancel Supergroup [{arg & 0xFFFF}]"
                table_for(ctx).patch_clear(arg & 0xFFFF)
            return d
        if op == 0x85:       # System Broadcast (BSI callsign)
            packed = 0
            for k in range(3, 9):
                packed = (packed << 8) | m[k]
            bsi = ""
            for shift in range(42, -1, -6):
                ch = (packed >> shift) & 0x3F
                if ch:
                    bsi += chr(ch + 43)
            return f"\n MFID90 (Moto) System Broadcast (BSI)\n  BSI [{bsi}]"
        if op in (0x82, 0x8F):   # Active Group Radios
            offsets = (4, 7, 11, 14) if op == 0x82 else (5, 8, 12, 15)
            status = m[3] if op == 0x8F else -1
            radios = [str(_u24(m, o)) for o in offsets
                      if o + 2 < length and _u24(m, o)]
            d = f"\n Motorola {op:02X} Active Group Radios\n "
            if status >= 0:
                d += f" Status [{status:02X}]"
            d += f" Radios [{', '.join(radios) if radios else 'NONE'}]"
            return d
        if op == 0xBF:       # Active Group Radios feature marker
            raw = "".join(f"{m[k]:02X}" for k in range(1, min(length, 9)))
            return f"\n Motorola Active Group Radios Feature Active MSG [{raw}]"
        if op == 0x8B:       # TDMA Data Channel
            chans = []
            for c, off in enumerate((4, 7, 10, 13)):
                if off + 1 < length:
                    ch = _u16(m, off)
                    if ch not in (0, 0xFFFF):
                        chans.append(f"CH{c + 1} [{ch:04X}]")
            return ("\n Motorola TDMA Data Channel "
                    + (" ".join(chans) if chans else "Not Active"))
        return f"\n MFID90 (Moto) OP {op:02X} len {length}"

    def _vendor_harris(self, op, m, length, slot, ctx, hit) -> str:
        """L3Harris MFID A4 (vpdu handle_harris_*)."""
        if op in (0xA0, 0xAC):   # Private / Unit-to-Unit Data Channel Grant
            chan, tgt = _u16(m, 4), _u24(m, 6)
            src = _u24(m, 9) if op == 0xAC else 0
            d = (f"\n L3Harris {'Unit-to-Unit' if op == 0xAC else 'Private'}"
                 f" Data Channel Grant\n  CHAN [{chan:04X}] Target [{tgt}]")
            if src:
                d += f" Source [{src}]"
            ctx.emit(f"       P25p2 MAC{d}", "p25p2", hit.pos,
                     channel=chan, src=src, grant=True, data=True)
            return d
        if op == 0xAA:           # GPS location payload
            # payload octets (from message octet 3) are re-based to
            # byte 5 of the GPS buffer so the fields sit at bit 40
            # (reference p25p2_vpdu_handle_harris_gps_location
            # :4958-4977 -> nmea_harris)
            from dsdneo_tpu_torch.protocol.p25.harris import decode_harris_gps
            payload_octets = length - 3
            if payload_octets <= 0:
                return "\n L3Harris GPS Location invalid: short message"
            bits = np.zeros(24 * 8, np.uint8)
            for i in range(min(payload_octets, len(m) - 3, 19)):
                v = int(m[3 + i])
                for j in range(8):
                    bits[8 * (5 + i) + j] = (v >> (7 - j)) & 1
            return "\n L3Harris GPS Location" + decode_harris_gps(bits)
        if op == 0xA8:           # self-contained talker alias
            # alias text from message octet 3 through the vendor length
            # octet (reference p25p2_vpdu.c :2350-2361, input[4..len]
            # with input[i] = message octet i-1 -> l3h_embedded_alias)
            from dsdneo_tpu_torch.protocol.p25.harris import sanitize_alias_char
            text = "".join(sanitize_alias_char(int(m[k]))
                           for k in range(3, min(length, len(m)))).strip()
            return f"\n MFID A4 (Harris) Talker Alias: {text}"
        return f"\n MFID A4 (Harris) OP {op:02X} len {length}"

    def _vendor_tait(self, op, m, length, slot, ctx, hit) -> str:
        if op == 0xB5:           # micro slot counter
            sc = _u16(m, 3)
            return f"\n MFID D8 (Tait) Micro Slot Counter [{sc:04X}]"
        return f"\n MFID D8 (Tait) OP {op:02X} len {length}"

    # ---- multi-fragment (vpdu consume_multifragment_*) ------------------
    def _frag_base(self, op, m, length, slot, ctx, hit) -> str:
        frag = self.frag[slot & 1]
        frag.clear()
        data_len = m[2] if length > 2 else 0
        if length < 3 or data_len <= 0:
            return f"\n MAC multi-fragment base {op:02X} invalid length"
        frag.active = True
        frag.opcode = op
        frag.data_len = data_len
        frag.data = list(m[2:length])
        d = (f"\n MAC Multi-Fragment Base Opcode [{op:02X}]"
             f" DataLen [{data_len}] Collected [{len(frag.data)}]")
        if len(frag.data) >= frag.data_len:
            d += self._frag_complete(slot, ctx, hit)
            frag.clear()
        return d

    def _frag_cont(self, m, length, slot, ctx, hit) -> str:
        frag = self.frag[slot & 1]
        if not frag.active:
            return "\n MAC Multi-Fragment Continuation ignored: no active base"
        need = frag.data_len - len(frag.data)
        frag.data.extend(m[2:2 + min(max(length - 2, 0), need)])
        d = (f"\n MAC Multi-Fragment Continuation Opcode [{frag.opcode:02X}]"
             f" DataLen [{frag.data_len}] Collected [{len(frag.data)}]")
        if len(frag.data) >= frag.data_len:
            d += self._frag_complete(slot, ctx, hit)
            frag.clear()
        return d

    def _frag_complete(self, slot, ctx, hit) -> str:
        f = self.frag[slot & 1]
        op = f.opcode
        if op in (0x71, 0xF1):
            seed = "".join(f"{f.u8(k):02X}" for k in range(11, 16))
            d = (f"\n Authentication Demand - Multi-Fragment Complete"
                 f"\n  Target [{f.u24(1)}] SUID [{f.suid(4)}.{f.u24(8)}]"
                 f" Seed [{seed}]")
            if f.has(26):
                d += " Challenge [" + "".join(
                    f"{f.u8(k):02X}" for k in range(21, 26)) + "]"
            return d
        if op in (0xC7, 0xCF):
            name = ("Unit-to-Unit Voice Channel Grant"
                    + ("" if op == 0xCF else " Update")
                    + " - Extended LCCH Complete")
            cht = f.chan(12)
            d = (f"\n {name}\n  SVC [{f.u8(1):02X}] CHAN-T [{cht:04X}]"
                 f" CHAN-R [{f.chan(14):04X}] Target [{f.u24(16)}]"
                 f" Source [{f.suid(5)}.{f.u24(2)}]")
            ctx.emit(f"       P25p2 MAC{d}", "p25p2", hit.pos,
                     src=f.u24(2), channel=cht, grant=True)
            return d
        if op == 0xCB:
            return (f"\n Call Alert - Extended LCCH Complete"
                    f"\n  Target [{f.u24(11)}] Source [{f.suid(4)}.{f.u24(1)}]")
        if op == 0xCD:
            silent = " Silent" if f.u8(2) & 0x80 else ""
            return (f"\n Radio Unit Monitor Command - Extended LCCH Complete"
                    f"\n  Target [{f.u24(3)}] Source [{f.suid(6)}.{f.u24(13)}]"
                    f" Time [{f.u8(1)}] Mult [{f.u8(2) & 3}]{silent}")
        if op == 0xCE:
            return (f"\n Message Update - Extended LCCH Complete"
                    f"\n  Target [{f.u24(3)}] Source [{f.suid(6)}.{f.u24(13)}]"
                    f" Message [{f.u16(1):04X}]")
        if op == 0xD9:
            return (f"\n Status Update - Extended LCCH Complete"
                    f"\n  Target [{f.u24(3)}] Source [{f.suid(6)}.{f.u24(13)}]"
                    f" Unit [{f.u8(1):02X}] User [{f.u8(2):02X}]")
        if op == 0xDB:
            return (f"\n Status Query - Extended LCCH Complete"
                    f"\n  Target [{f.u24(1)}] Source [{f.suid(4)}.{f.u24(11)}]")
        if op == 0xDE:
            silent = " Silent" if f.u8(11) & 0x80 else ""
            tg_mode = " TG" if f.u8(11) & 0x40 else ""
            return (f"\n Radio Unit Monitor Enhanced Command - Extended Complete"
                    f"\n  Target [{f.u24(1)}] Source [{f.suid(4)}.{f.u24(16)}]"
                    f" Time [{f.u8(12)}] ALG [{f.u8(15):02X}]"
                    f" KID [{f.u16(13):04X}]{silent}{tg_mode}")
        if op == 0xE0:
            return (f"\n Acknowledge Response FNE - Extended Complete"
                    f"\n  Service [{f.u8(1) & 0x3F:02X}]"
                    f" Target [{f.suid(9)}.{f.u24(19)}]"
                    f" Source [{f.suid(2)}.{f.u24(16)}]")
        return f"\n MAC Multi-Fragment Complete Opcode [{op:02X}]"


_STANDARD_HANDLERS = {
    0x03: P2MacWalker._h_tele_voice_user,
    0x30: P2MacWalker._h_std_regroup_voice,
    0x40: P2MacWalker._h_grp_grant,
    0x41: P2MacWalker._h_grp_service_req,
    0x42: P2MacWalker._h_grp_update_implicit,
    0x43: P2MacWalker._h_grp_update_explicit_abbrev,
    0x44: P2MacWalker._h_uu_grant,
    0x46: P2MacWalker._h_uu_grant,
    0x45: P2MacWalker._h_uu_answer_req,
    0xC5: P2MacWalker._h_uu_answer_req,
    0x4A: P2MacWalker._h_tele_answer_req,
    0x4C: P2MacWalker._h_rum,
    0xCC: P2MacWalker._h_rum,
    0x58: P2MacWalker._h_status_update,
    0xD8: P2MacWalker._h_status_update,
    0x5A: P2MacWalker._h_query_alert,
    0x5F: P2MacWalker._h_query_alert,
    0x6A: P2MacWalker._h_query_alert,
    0xDA: P2MacWalker._h_query_alert,
    0xDF: P2MacWalker._h_query_alert,
    0xEA: P2MacWalker._h_query_alert,
    0x5C: P2MacWalker._h_message_update,
    0xDC: P2MacWalker._h_message_update,
    0x5E: P2MacWalker._h_rum_enhanced,
    0x60: P2MacWalker._h_ack_response,
    0x76: P2MacWalker._h_roaming_cmd,
    0x77: P2MacWalker._h_roaming_update,
    0xC0: P2MacWalker._h_grp_grant_explicit,
    0xC3: P2MacWalker._h_grp_grant_explicit,
    0xC4: P2MacWalker._h_uu_grant_extended,
    0xC6: P2MacWalker._h_uu_grant_extended,
    0xE4: P2MacWalker._h_ext_func_extended,
    0xE5: P2MacWalker._h_ext_func_extended,
    0xE8: P2MacWalker._h_grp_aff_rsp_extended,
}
