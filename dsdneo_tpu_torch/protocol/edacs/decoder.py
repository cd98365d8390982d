"""EDACS control-channel message catalogs (host, numpy).

The port's own copy of ``dsdneo_tpu/protocol/edacs/decoder.py``: the
BCH(40,28) code of the control channel's two 40-bit words (a shortened
(63,51) t=2 BCH code over GF(64) = GF(2)[x]/(x^6 + x + 1): 28 message
bits and 12 parity bits, most significant first) and the standard and
extended-addressing (EA) message catalogs the batched monitor parses
its BCH-valid words with (reference src/protocol/edacs/edacs-fme.c).
``EdacsDecoder.handle`` is the serial frame reader of the serial decode
path (``engine.decoder``), registered for ``edacs``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from dsdneo_tpu_torch.params import _poly_mod
from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                            ProtocolDecoder, register)
from dsdneo_tpu_torch.protocol.edacs.afs import state_split
from dsdneo_tpu_torch.symbols.framesync import SyncHit

# generator polynomial of BCH(40,28), bit i the coefficient of x^i: the
# product of the minimal polynomials of alpha and alpha^3 in GF(64),
# degree 12
BCH_40_28_GEN = 0x1539


@lru_cache(maxsize=None)
def _bch_basis() -> np.ndarray:
    """Parity rows of BCH(40,28): ``[28, 12]`` uint8, row i the 12 parity
    bits (most significant first) of message bit i (of 28, most
    significant first)."""
    rows = np.zeros((28, 12), dtype=np.uint8)
    for i in range(28):
        rem = _poly_mod((1 << (27 - i)) << 12, BCH_40_28_GEN)
        rows[i] = [(rem >> (11 - j)) & 1 for j in range(12)]
    return rows


def edacs_bch_encode(msg28: int) -> int:
    """28-bit message → 40-bit codeword (data ‖ parity)."""
    basis = _bch_basis()
    bits = np.array([(msg28 >> (27 - i)) & 1 for i in range(28)],
                    dtype=np.uint8)
    parity = bits @ basis % 2
    word = msg28 << 12
    for j in range(12):
        word |= int(parity[j]) << (11 - j)
    return word


LCN_STATUS = {28: "[Convert To Callee]", 29: "[Call Queued]",
              30: "[System Busy]", 31: "[Call Denied]",
              26: "[Reserved LCN Status]", 27: "[Reserved LCN Status]"}


def _lcn_status(lcn: int) -> str:
    return LCN_STATUS.get(lcn, "")


@register("edacs")
class EdacsDecoder(ProtocolDecoder):
    """The EDACS frame reader and message catalogs: ``handle`` votes the
    frame's two BCH(40,28) words; ``_standard`` and ``_extended`` parse
    one BCH-valid pair of 28-bit messages into the frame's line and emit
    the grant events into the context."""

    protocol = "edacs"

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        pos = hit.end
        if pos + 240 > len(reader.dibits):
            return len(reader.dibits)
        dd = reader.dibits[pos:pos + 240].astype(np.uint8)
        bits = (dd >> 1) & 1                      # 2-level: negative symbol = 1
        if reader.invert:
            bits = bits ^ 1
        frames = [self._word(bits[i * 40:(i + 1) * 40]) for i in range(6)]
        msg1 = self._vote(frames[0], frames[1], frames[2])
        msg2 = self._vote(frames[3], frames[4], frames[5])
        # resolve channel polarity by BCH validity (an inverted channel
        # complements every 40-bit word)
        inverted = reader.invert
        if (edacs_bch_encode(msg1 >> 12) != msg1
                or edacs_bch_encode(msg2 >> 12) != msg2):
            m1c = (~msg1) & 0xFFFFFFFFFF
            m2c = (~msg2) & 0xFFFFFFFFFF
            if (edacs_bch_encode(m1c >> 12) == m1c
                    and edacs_bch_encode(m2c >> 12) == m2c):
                msg1, msg2 = m1c, m2c
                inverted = not inverted
            else:
                ctx.emit(f"Sync: {'-' if inverted else '+'}EDACS  BCH FAIL",
                         "edacs", hit.pos)
                return pos + 240
        m1, m2 = msg1 >> 12, msg2 >> 12
        # ESK (Encryption Sync Key) scramble: 8-bit mask XORed over the
        # top command bits (reference edacs_process_valid_frame
        # fr_esk_mask = esk_mask << 20)
        esk = int(getattr(ctx.state, "edacs_esk", 0) or 0)
        if esk:
            m1 ^= (esk & 0xFF) << 20
            m2 ^= (esk & 0xFF) << 20
        if getattr(ctx.state, "edacs_ea", False):
            line = self._extended(m1, m2, ctx, hit)
        else:
            line = self._standard(m1, m2, ctx, hit)
        # both 28-bit words passed BCH: carry the raw command as a
        # structured field (validated-decode evidence for auto mode)
        ctx.emit(f"Sync: {'-' if inverted else '+'}EDACS {line}", "edacs",
                 hit.pos, mt=m1 >> 23, word=m1)
        return pos + 240

    @staticmethod
    def _word(bits: np.ndarray) -> int:
        v = 0
        for b in bits:
            v = (v << 1) | int(b)
        return v

    @staticmethod
    def _vote(a: int, b: int, c: int) -> int:
        b = (~b) & 0xFFFFFFFFFF
        return (a & b) | (a & c) | (b & c)


    # -- extended addressing (EA) mode ------------------------------------
    def _extended(self, msg1: int, msg2: int, ctx: DecoderContext,
                  hit: SyncHit) -> str:
        """EDACS EA message catalog (reference edacs-fme.c
        edacs_handle_extended_mt1/mt2)."""
        mt1 = (msg1 >> 23) & 0x1F
        mt2 = (msg1 >> 19) & 0xF
        s = ctx.state
        if mt1 in (0x01, 0x02):
            lcn = (msg1 >> 17) & 0x1F
            group = msg1 & 0xFFFF
            src = msg2 & 0xFFFFF
            kind = "TDMA" if mt1 == 0x01 else "Data"
            ctx.emit(f"       EDACS EA {kind} Group Call G {group}", "edacs",
                     hit.pos, tg=group, src=src, lpcn=lcn,
                     grant=0 < lcn < 26, data=mt1 == 0x02)
            return (f" {kind} Group Call :: Group [{group:05d}]"
                    f" Source [{src:08d}] LCN [{lcn:02d}]{_lcn_status(lcn)}")
        if mt1 in (0x03, 0x06):
            lcn = (msg1 >> 17) & 0x1F
            update = (msg1 >> 16) & 1
            group = msg1 & 0xFFFF
            tx_trunk = (msg2 >> 21) & 1
            emergency = (msg2 >> 20) & 1
            src = msg2 & 0xFFFFF
            s.last_tg, s.last_src = group, src
            kind = "Digital" if mt1 == 0x03 else "Analog"
            what = "Update" if update else "Assignment"
            line = (f" {kind} Group Call {what} :: Group [{group:05d}]"
                    f" Source [{src:08d}] LCN [{lcn:02d}]{_lcn_status(lcn)}")
            if not tx_trunk:
                line += " [Message Trunking]"
            if emergency:
                line += " [EMERGENCY]"
            ctx.emit(f"       EDACS EA Voice Grant G {group} LCN {lcn}",
                     "edacs", hit.pos, tg=group, src=src, lpcn=lcn,
                     grant=0 < lcn < 26,
                     emergency=bool(emergency))
            return line
        if mt1 == 0x10:
            lcn = (msg2 >> 20) & 0x1F
            digital = (msg1 >> 21) & 1
            update = (msg1 >> 20) & 1
            tgt = msg1 & 0xFFFFF
            src = msg2 & 0xFFFFF
            kind = "Digital" if digital else "Analog"
            what = "Update" if update else "Assignment"
            ctx.emit(f"       EDACS EA I-Call {what}", "edacs", hit.pos,
                     src=src, lpcn=lcn, grant=0 < lcn < 26)
            return (f" {kind} I-Call {what} :: Target [{tgt:08d}]"
                    f" Source [{src:08d}] LCN [{lcn:02d}]{_lcn_status(lcn)}")
        if mt1 == 0x12:
            lcn = (msg2 >> 20) & 0x1F
            src = msg2 & 0xFFFFF
            return (f" Channel Assignment (Unknown Data) ::"
                    f" Source [{src:08d}] LCN [{lcn:02d}]{_lcn_status(lcn)}")
        if mt1 == 0x16:
            lcn = (msg1 >> 17) & 0x1F
            digital = (msg1 >> 16) & 1
            src = msg2 & 0xFFFFF
            kind = "Digital" if digital else "Analog"
            return (f" {kind} System All-Call :: Source [{src:08d}]"
                    f" LCN [{lcn:02d}]{_lcn_status(lcn)}")
        if mt1 == 0x19:
            group = msg1 & 0xFFFF
            src = msg2 & 0xFFFFF
            return f" Login :: Group [{group:05d}] Source [{src:08d}]"
        if mt1 != 0x1F:
            return f" Unknown EA Command (MT1: {mt1:02X})"
        # MT2 space
        if mt2 == 0x0:
            return " Initiate Test Call Command"
        if mt2 == 0x1:
            lcn = (msg1 >> 12) & 0x1F
            idx = (msg1 >> 8) & 0xF
            site = msg1 & 0xFF
            return (f" Adjacent Site :: Site ID [{site:02X}][{site:03d}]"
                    f" Index [{idx}] on CC LCN [{lcn:02d}]{_lcn_status(lcn)}")
        if mt2 == 0x4:
            status = msg1 & 0xFF
            src = msg2 & 0xFFFFF
            return (f" Status/Message :: Status [{status:03d}]"
                    f" Source [{src:08d}]")
        if mt2 == 0x7:
            qual = {0: "[Temporary Disable]", 1: "[Corrupt Personality]",
                    2: "[Revoke Logical ID]"}.get((msg2 >> 26) & 3,
                                                  "[Re-enable Unit]")
            return f" Unit Enable/Disable :: {qual} Target [{msg2 & 0xFFFFF:08d}]"
        if mt2 == 0x8:
            system = msg1 & 0xFFFF
            lcn = msg2 & 0x1F
            s.edacs_sysid = system
            return f" System Information :: System ID [{system:04X}] CC LCN [{lcn:02d}]"
        if mt2 == 0xA:
            site = ((msg1 & 0x7000) >> 7) | (msg1 & 0x1F)
            area = (msg1 >> 5) & 0x7F
            s.p2_siteid = site
            return (f" Extended Addressing :: Site ID [{site:02X}][{site:03d}]"
                    f" Area [{area:02X}][{area:03d}]")
        if mt2 == 0xB:
            return " System Dynamic Regroup Plan Bitmap"
        if mt2 == 0xC:
            return " Dynamic Regrouping"
        if mt2 == 0xD:
            return " Serial Number Request"
        return f" Unknown EA Command (MT2: {mt2:X})"

    # -- standard mode ----------------------------------------------------
    def _standard(self, msg1: int, msg2: int, ctx: DecoderContext,
                  hit: SyncHit = None) -> str:
        mt_a = (msg1 >> 25) & 0x7
        mt_b = (msg1 >> 22) & 0x7
        mt_d = (msg1 >> 17) & 0x1F
        s = ctx.state
        if mt_a in (0, 1, 2, 3):
            # reference edacs_handle_standard_mt_a_voice_group_assignment:
            # lid spans msg1[24:18]|msg2[23:17], lcn msg1[16:12]
            lid = ((msg1 & 0x1FC0000) >> 11) | ((msg2 & 0xFE0000) >> 17)
            lcn = (msg1 >> 12) & 0x1F
            tx_trunk = (msg1 >> 11) & 1
            group = msg1 & 0x7FF
            s.last_tg, s.last_src = group, lid
            digital = mt_a in (2, 3)
            emergency = mt_a in (1, 3)
            # AFS call-scope tags (reference edacs-fme.c:1296-1320 +
            # isAgencyCallGroup/isFleetCallGroup with the configured
            # a:f:s bit split)
            split = state_split(s)
            tags = ""
            if split.is_agency_call(group):
                tags += " [Agency]"
            elif split.is_fleet_call(group):
                tags += " [Fleet]"
            if not tx_trunk:
                tags += " [Message Trunking]"
            ctx.emit(f"       EDACS Voice Grant G {group} LCN {lcn}",
                     "edacs", hit.pos if hit else 0, tg=group, src=lid,
                     lpcn=lcn, grant=0 < lcn < 26,
                     emergency=emergency, afs=split.format(group))
            return (f" Voice Group Channel Assignment ::"
                    f" {'Digital' if digital else 'Analog'}"
                    f" Group [{group:04d}]"
                    f" LID [{lid:05d}] LCN [{lcn:02d}]{_lcn_status(lcn)}"
                    + tags
                    + (" [EMERGENCY]" if emergency else ""))
        if mt_a == 5:
            return " Data Call Channel Assignment"
        if mt_a == 6:
            return " Login Acknowledge"
        if mt_a != 7:
            return f" Reserved Command (MT-A: {mt_a:X})"
        # MT-B space
        if mt_b == 0:
            return " Status/Message"
        if mt_b == 1:
            return " Interconnect Channel Assignment"
        if mt_b == 3:
            mt_c = (msg1 >> 20) & 0x3
            lcn = (msg1 >> 15) & 0x1F
            indiv = (msg1 >> 14) & 1
            group = msg1 & 0x7FF
            kind = "Digital" if mt_c in (1, 3) else "Analog"
            if indiv:
                return (f" Voice Individual Channel Update :: LID "
                        f"[{msg1 & 0x3FFF:05d}] LCN [{lcn:02d}]{_lcn_status(lcn)}")
            return (f" Voice Group Channel Update :: {kind} Group [{group:04d}]"
                    f" LCN [{lcn:02d}]{_lcn_status(lcn)}")
        if mt_b == 4:
            return " System Assigned ID"
        if mt_b == 5:
            return " Voice Individual Channel Assignment"
        if mt_b == 6:
            return " Console Unkey/Drop"
        if mt_b != 7:
            return f" Reserved Command (MT-B: {mt_b:X})"
        # MT-D space
        if mt_d == 0x00:
            return " Cancel Dynamic Regroup"
        if mt_d == 0x01:
            lcn = (msg1 >> 12) & 0x1F
            idx = (msg1 >> 9) & 0x7
            site = (msg1 >> 4) & 0x1F
            if site == 0 and idx == 0:
                kind = "[Adjacency Table Reset]"
            elif site != 0 and idx == 0:
                kind = "[Priority System Definition]"
            elif site == 0:
                kind = "[Adjacencies Table Length Definition]"
            else:
                kind = "[Adjacent System Definition]"
            return (f" Adjacent Site Control Channel :: Site ID [{site:02X}]"
                    f"[{site:03d}] Index [{idx}] LCN [{lcn:02d}]"
                    f"{_lcn_status(lcn)} {kind}")
        if mt_d == 0x02:
            return " Extended Site Options"
        if mt_d == 0x04:
            return " System Dynamic Regroup Plan Bitmap"
        if mt_d == 0x05:
            return " Assignment to Auxiliary CC"
        if mt_d == 0x06:
            return " Initiate Test Call Command"
        if mt_d == 0x07:
            qual = {0: "[Temporary Disable]", 1: "[Corrupt Personality]",
                    2: "[Revoke Logical ID]"}.get((msg1 >> 14) & 3,
                                                  "[Re-enable Unit]")
            return (f" Unit Enable/Disable :: {qual}"
                    f" LID [{msg1 & 0x3FFF:05d}]")
        if mt_d in (0x08, 0x09, 0x0A, 0x0B):
            cc_lcn = (msg1 >> 12) & 0x1F
            priority = (msg1 >> 9) & 0x7
            site = msg1 & 0x1F
            s.p2_siteid = site
            return (f" Standard/Networked :: Site ID [{site:02X}][{site:03d}]"
                    f" Priority [{priority}] CC LCN [{cc_lcn:02d}]"
                    f"{_lcn_status(cc_lcn)}")
        if mt_d == 0x0F:
            return " System All-Call"
        if mt_d == 0x10:
            return " Dynamic Regrouping"
        return f" Reserved Command (MT-D: {mt_d:02X})"
