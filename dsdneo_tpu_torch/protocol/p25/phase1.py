"""The P25 Phase 1 TSBK catalog (host, numpy only).

The port's own copy of the TSBK part of ``P25P1Decoder`` in
``dsdneo_tpu/protocol/p25/phase1.py`` (``_iden_table``,
``_chan_freq_note``, ``_iden_update``, ``_tsbk_isp``,
``_tsbk_isp_mfid90``, ``_queued_deny``, ``_mfid90``, ``_tsbk``): every
branch of the decision logic as it stands there, so a CRC-valid TSBK
gives the same event lines and fields in both packages.  The LDU, HDU,
TDULC and MPDU readers are not here: the batched control-channel
monitor (``engine.ccbatch``) parses TSBK payloads only.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.base import DecoderContext
from dsdneo_tpu_torch.symbols.framesync import SyncHit


class P25P1Decoder:
    protocol = "p25p1"

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
