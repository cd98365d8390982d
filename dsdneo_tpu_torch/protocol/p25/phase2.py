"""P25 Phase 2 (TDMA, 6000 sym/s) burst decoder: the control part.

The port's own copy of the xCCH and MAC part of ``P25P2Decoder`` in
``dsdneo_tpu/protocol/p25/phase2.py`` (reference parity
src/protocol/p25/phase2/p25p2_frame.c).  A Phase 2 frame is a 20-symbol
sync and 4 timeslots of 360 bits; each timeslot's DUID is an 8-bit
codeword (bits 0, 1, 74, 75, 244, 245, 318, 319) from the canonical set
below.  With WACN/SYS/NAC known (from NET_STS, the pipeline's arguments
or the blind recovery), SACCH/FACCH are descrambled at their superframe
position, RS(63,35)-corrected, CRC12-checked and their MAC PDUs parsed
through ``protocol.p25.p2_mac``; without them the scrambled bursts feed
the blind recovery of the scramble seed.  The superframe walk, the ISCH
tracking and the voice timeslots are the batched pipelines' work
(``engine.p2batch``, ``engine.ccbatch``).
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.base import DecoderContext, ProtocolDecoder
from dsdneo_tpu_torch.protocol.p25 import p2_xcch

# canonical DUID codewords (TIA-102.BBAC; reference p25p2_frame.c:141)
DUID_CANONICAL = [0x00, 0x17, 0x2E, 0x39, 0x4B, 0x5C, 0x65, 0x72,
                  0x8D, 0x9A, 0xA3, 0xB4, 0xC6, 0xD1, 0xE8, 0xFF]

DUID_OFFSETS = [0, 1, 74, 75, 244, 245, 318, 319]

MAC_HEADER_NAMES = {1: "MAC_PTT", 2: "MAC_END", 3: "MAC_IDLE",
                    4: "MAC_ACTIVE", 6: "MAC_HANGTIME"}


def duid_lookup(received: int) -> int:
    """Nearest-codeword DUID decode (distance ≤ 2), else -1."""
    best, best_d, ties = -1, 9, 0
    for idx, c in enumerate(DUID_CANONICAL):
        d = bin(received ^ c).count("1")
        if d < best_d:
            best, best_d, ties = idx, d, 0
        elif d == best_d:
            ties += 1
    if best_d > 2 or (best_d > 0 and ties):
        return -1
    return best


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


class P25P2Decoder(ProtocolDecoder):
    protocol = "p25p2"

    def __init__(self):
        self.sf_pos: int | None = None   # superframe timeslot position 0-11
        self._scramble: np.ndarray | None = None
        self._scramble_key = None
        # per-slot voice crypto state (reference p25p2_frame.c: payload_miP/
        # miN, dropL/dropR=256 per superframe); MAC_PTT and MAC_END set it
        self.fourv = {0: 0, 1: 0}
        # scrambled bursts collected while WACN/SYS/NAC are unknown,
        # fed to the blind seed recovery (_try_recover_params)
        self._pending_scrambled: list = []
        self.crypto = {0: {"alg": 0, "kid": 0, "mi": 0, "drop": 256,
                           "staged": None},
                       1: {"alg": 0, "kid": 0, "mi": 0, "drop": 256,
                           "staged": None}}

    def _scramble_bits(self, s) -> np.ndarray:
        key = (s.p2_wacn, s.p2_sysid, s.p2_cc)
        if self._scramble_key != key:
            # 12 timeslots + slack for the +20 bit alignment offset
            self._scramble = p2_xcch.generate_scramble_bits(*key, 4800)
            self._scramble_key = key
        return self._scramble

    def _descramble(self, ts_bits, kind, s):
        """XOR with the LFSR sequence at this timeslot's superframe
        position (reference p25p2_frame.c:378-384, +20 bit offset)."""
        p = self.sf_pos if self.sf_pos is not None else 0
        lbit = self._scramble_bits(s)
        base = 360 * p + 20
        x = ts_bits ^ lbit[base:base + 360]
        if kind == "sacch":
            return p2_xcch.extract_sacch(x)
        return p2_xcch.extract_facch(x)

    def _try_recover_params(self, ts_bits, kind, lcch, ctx, hit,
                             slot) -> str:
        """Blind WACN/SYS/NAC recovery from accumulated scrambled xCCH
        bursts (p2_xcch.recover_scramble_seed: the keystream and the
        RS(63,35) parity map are both GF(2)-linear, so one clean burst
        determines the 44-bit seed).  The reference can only learn the
        identity from an unscrambled NET_STS broadcast or the -X flag
        (src/protocol/p25/phase2/p25p2_vpdu.c); this decodes the
        control channel with zero prior knowledge."""
        if self.sf_pos is None:
            return ""
        self._pending_scrambled.append(
            (ts_bits.copy(), self.sf_pos, kind, slot, lcch))
        if len(self._pending_scrambled) > 64:
            self._pending_scrambled.pop(0)
        newest = self._pending_scrambled[-1]
        got = p2_xcch.recover_scramble_seed(
            [(newest[0], newest[1], newest[2])]
            + [(t, p, k) for t, p, k, _, _ in self._pending_scrambled[:-1]])
        if got is None:
            return ""
        wacn, sysid, nac = got
        s = ctx.state
        s.p2_wacn, s.p2_sysid, s.p2_cc = wacn, sysid, nac
        ctx.emit(f"       P25p2 scramble parameters recovered from RS "
                 f"parity: WACN [{wacn:05X}] SYSID [{sysid:03X}] "
                 f"NAC [{nac:03X}]", "p25p2", hit.pos)
        # retroactively decode the bursts collected while hunting
        pending, self._pending_scrambled = self._pending_scrambled[:-1], []
        for tb, p, k, sl, lc in pending:
            saved = self.sf_pos
            self.sf_pos = p
            detail = self._xcch(tb, 0, k, scrambled=True, lcch=lc,
                                ctx=ctx, have_params=True, hit=hit, slot=sl)
            self.sf_pos = saved
            if detail:
                ctx.emit(f"       P25p2 SACCH (recovered){detail}",
                         "p25p2", hit.pos, slot=sl)
        return self._xcch(ts_bits, 0, kind, scrambled=True, lcch=lcch,
                          ctx=ctx, have_params=True, hit=hit, slot=slot)

    def _xcch(self, ts_bits, fc, kind, scrambled, lcch, ctx, have_params,
              hit, slot) -> str:
        if scrambled and not have_params:
            return self._try_recover_params(ts_bits, kind, lcch, ctx,
                                            hit, slot)
        if scrambled:
            payload, parity = self._descramble(ts_bits, kind, ctx.state)
        else:
            ex = p2_xcch.extract_sacch if kind == "sacch" else p2_xcch.extract_facch
            payload, parity = ex(ts_bits)
        corrected, nerr = p2_xcch.xcch_rs_decode(payload, parity, kind)
        if nerr < 0:
            return " R-S ERR"
        n = len(corrected)
        if lcch:
            crc_ok = True          # LCCH uses CRC16 over 164; lenient here
        else:
            crc_ok = p2_xcch.crc12_ok(corrected, n - 12)
        if not crc_ok:
            # -F relax-CRC (reference): proceed to the MAC parse with
            # the failure noted instead of discarding the burst
            if getattr(ctx.state, "relax_crc", False):
                return (" CRC12 ERR (relaxed)"
                        + self._mac_pdu(corrected, kind, ctx, hit, slot))
            return " CRC12 ERR"
        return self._mac_pdu(corrected, kind, ctx, hit, slot)

    # -- MAC PDU ----------------------------------------------------------
    def _mac_pdu(self, payload: np.ndarray, kind: str, ctx: DecoderContext,
                 hit, slot: int) -> str:
        """Header + message walk (reference p25p2_xcch.c
        process_SACCH/FACCH_MAC_PDU, p25p2_mac_tables.c lengths)."""
        opcode = _bti(payload[0:3])
        n_oct = 22 if kind == "sacch" else 19
        mac = np.zeros(24, dtype=np.int64)
        for i in range(n_oct):
            mac[i] = _bti(payload[8 * i:8 * i + 8])
        name = MAC_HEADER_NAMES.get(opcode, f"MAC_{opcode}")
        detail = f" {name}"
        if opcode == 1:      # MAC_PTT: MI, alg, key, group, source
            mi = 0
            for i in range(1, 9):
                mi = (mi << 8) | int(mac[i])
            alg = int(mac[9])
            kid = (int(mac[10]) << 8) | int(mac[11])
            src = (int(mac[13]) << 16) | (int(mac[14]) << 8) | int(mac[15])
            tg = (int(mac[16]) << 8) | int(mac[17])
            ctx.state.last_tg, ctx.state.last_src = tg, src
            detail += (f"\n VCH {slot + 1} - TG {tg} SRC {src} "
                       f"ALG {alg:02X} KEY {kid:04X}")
            # install voice crypto for this slot (reference p25p2_xcch.c
            # MAC_PTT handling: set MI + drop=256)
            self.crypto[slot].update(alg=alg, kid=kid, mi=mi, drop=256,
                                     staged=None)
            self.fourv[slot] = 0
            if alg not in (0, 0x80):
                detail += f" MI: 0x{mi:016X}"
        elif opcode == 2:    # MAC_END
            self.crypto[slot].update(alg=0, mi=0, staged=None)
            src = (int(mac[13]) << 16) | (int(mac[14]) << 8) | int(mac[15])
            tg = (int(mac[16]) << 8) | int(mac[17])
            detail += f" TG {tg} SRC {src}"
        elif opcode in (0, 3, 4, 6):
            detail += self._mac_messages(mac, n_oct, ctx, hit, slot)
        return detail

    def _mac_messages(self, mac: np.ndarray, n_oct: int, ctx: DecoderContext,
                      hit, slot: int = 0) -> str:
        """Walk MAC messages through the native Phase 2 catalog
        (p2_mac.P2MacWalker): P2-specific layouts (explicit/extended
        grants, vendor partitions, multi-fragment LCCH) decode natively;
        TSBK-coincident broadcast messages bridge to the P1 parsers."""
        return self._walker().walk(mac, n_oct, slot, ctx, hit)

    def _walker(self):
        if not hasattr(self, "_mac_walker"):
            from dsdneo_tpu_torch.protocol.p25.p2_mac import P2MacWalker
            from dsdneo_tpu_torch.protocol.p25.phase1 import P25P1Decoder
            self._mac_walker = P2MacWalker(P25P1Decoder)
        return self._mac_walker
