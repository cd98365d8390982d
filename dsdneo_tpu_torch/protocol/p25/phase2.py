"""P25 Phase 2 (TDMA, 6000 symbols/s) serial frame decoder (host, numpy).

The port's own copy of ``dsdneo_tpu/protocol/p25/phase2.py`` (reference
parity src/protocol/p25/phase2/p25p2_frame.c).  After the 20-symbol
sync, 700 dibits cover 4 timeslots of 360 bits (the 4th 320: its ISCH
slot is the next sync).  Each timeslot's DUID is an 8-bit codeword
(bits 0, 1, 74, 75, 244, 245, 318, 319) from the canonical set below;
the ISCH field at bits 320-359 locates the timeslot in the 12-slot
superframe.  With WACN/SYS/NAC known (the -X flag's ``p2_params``,
NET_STS, or the blind recovery from the RS parity of scrambled bursts),
SACCH/FACCH are descrambled, RS(63,35)-corrected, CRC12-checked and
their MAC PDUs parsed through ``protocol.p25.p2_mac``, and the 4V/2V
voice timeslots give their AMBE+2 frames: descrambled, ECC-corrected,
ADP/RC4-decrypted with the ESS or MAC_PTT keys, synthesized on the
context's device (``vocoder.synth.synthesize_frames``) and smoothed per
slot by ``runtime.jitter.P2AudioJitterRing``.  Without the parameters
bursts are typed only — the reference's "P2 Missing Parameters".  The
serial path (``engine.decoder``) registers :class:`P25P2Decoder`; the
batched control monitor (``engine.ccbatch.BatchedP2ControlPipeline``)
builds one for its xCCH and MAC part.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import rs
from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                      ProtocolDecoder, register)
from dsdneo_tpu_torch.protocol.p25 import p2_xcch
from dsdneo_tpu_torch.symbols.framesync import SyncHit

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


@register("p25p2")
class P25P2Decoder(ProtocolDecoder):
    protocol = "p25p2"

    def __init__(self):
        self.sf_pos: int | None = None   # superframe timeslot position 0-11
        self._scramble: np.ndarray | None = None
        self._scramble_key = None
        # per-slot voice crypto state (reference p25p2_frame.c: payload_miP/
        # miN, dropL/dropR=256 per superframe, ESS_B fragments + ESS_A parity)
        self.fourv = {0: 0, 1: 0}
        # scrambled bursts collected while WACN/SYS/NAC are unknown,
        # fed to the blind seed recovery (_try_recover_params)
        self._pending_scrambled: list = []
        self.ess_b = {0: np.zeros(96, np.uint8), 1: np.zeros(96, np.uint8)}
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

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        pos = hit.end
        if pos + 700 > len(reader.dibits):
            return len(reader.dibits)
        dd = reader.dibits[pos:pos + 700].astype(np.uint8)
        if reader.invert:
            dd = dd ^ 2
        bits = np.empty(1400, dtype=np.uint8)
        bits[0::2] = (dd >> 1) & 1
        bits[1::2] = dd & 1

        s = ctx.state
        have_params = bool(s.p2_wacn and s.p2_sysid and s.p2_cc)
        head = f"Sync: {hit.sync.name} "
        if not have_params:
            head += " P2 Missing Parameters            "
        ctx.emit(head, "p25p2", hit.pos)

        slot = 0
        for ts in range(4):
            if ts < 3:
                ts_bits = bits[ts * 360:(ts + 1) * 360]
                self._isch(ts_bits, ts)
            else:
                # the 4th burst is 320 bits — its trailing ISCH slot is
                # the NEXT frame sync (the +P25p2 pattern is the dibit
                # form of ISCH_SYNC), so there is no ISCH to process
                # (reference p25p2_frame.c burst walk)
                ts_bits = np.zeros(360, dtype=np.uint8)
                ts_bits[:320] = bits[1080:1400]
            received = 0
            for off in DUID_OFFSETS:
                received = (received << 1) | int(ts_bits[off])
            duid = duid_lookup(received)
            slot_label = f"LCH {slot} "
            detail = ""
            if duid in (3, 12, 13, 4):
                name = "SACCH " if duid in (3, 12) else ("LCCH  " if duid == 13 else "LCCHs ")
                detail = self._xcch(ts_bits, ts, "sacch",
                                    scrambled=duid in (3, 4),
                                    lcch=duid in (13, 4), ctx=ctx,
                                    have_params=have_params, hit=hit, slot=slot)
            elif duid in (9, 15):
                name = slot_label + "FACCH "
                detail = self._xcch(ts_bits, ts, "facch",
                                    scrambled=duid == 9, lcch=False, ctx=ctx,
                                    have_params=have_params, hit=hit, slot=slot)
            elif duid in (0, 6):
                name = slot_label + ("4V" if duid == 0 else "2V")
                if have_params:
                    detail = self._voice(ts_bits, 4 if duid == 0 else 2,
                                         slot, ctx)
            elif duid < 0:
                name = slot_label + f" DUID ERR {received:02X}"
            else:
                name = slot_label + f"DUID {duid}"
            ctx.emit(f"       P25p2 {name}{detail}", "p25p2", hit.pos,
                     ts=ts, duid=duid,
                     sf_pos=(self.sf_pos if self.sf_pos is not None
                             else -1))
            if self.sf_pos is not None:
                self.sf_pos = (self.sf_pos + 1) % 12
            slot ^= 1
        return pos + 700

    def _voice(self, ts_bits: np.ndarray, n_frames: int, slot: int,
               ctx: DecoderContext) -> str:
        """4V/2V: AMBE+2 frames at timeslot bit offsets {2,76,172,246}
        after descrambling (reference p25p2_frame.c
        p25p2_unpack_voice_frames); shares the DMR AMBE deinterleave.
        4V bursts carry a 24-bit ESS_B fragment at bit 148, the 2V burst
        carries the 168 ESS_A RS parity bits (p25p2_collect_ess_b_fragment
        / p25p2_collect_ess_a); the decoded ESS rekeys the NEXT
        superframe (p25p2_ess_stage_rekey + post_2v drop reset)."""
        from dsdneo_tpu_torch.protocol.dmr.ambe_frame import decode_ambe_ecc
        from dsdneo_tpu_torch.vocoder.mbe import decode_ambe_2450
        from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
        p = self.sf_pos if self.sf_pos is not None else 0
        lbit = self._scramble_bits(ctx.state)
        x = ts_bits ^ lbit[360 * p + 20:360 * p + 380]
        detail = ""
        if n_frames == 4:
            c = self.fourv[slot]
            if c == 0:
                self.ess_b[slot][:] = 0
            self.ess_b[slot][24 * c:24 * (c + 1)] = x[148:172]
            self.fourv[slot] = (c + 1) % 4
        params = []
        for off in (2, 76, 172, 246)[:n_frames]:
            bits72 = x[off:off + 72]
            bits49, _errs = decode_ambe_ecc(bits72)
            bits49 = self._decrypt_ambe(bits49, slot, ctx)
            params.append(decode_ambe_2450(bits49))
        if n_frames == 2:
            detail = self._process_ess(x, slot, ctx)
        pcm = synthesize_frames(params, ctx.device)
        if not pcm.size:
            return detail
        # per-slot jitter ring smooths the irregular 4V/2V cadence into
        # steady 160-sample frames (reference p25_p2_audio_ring.h)
        if not hasattr(self, "jitter"):
            from dsdneo_tpu_torch.runtime.jitter import P2AudioJitterRing
            self.jitter = P2AudioJitterRing()
        self.jitter.push_pcm(slot, pcm)
        out = []
        while self.jitter.depth(slot) > 0:
            fr, _ok = self.jitter.pop(slot)
            out.append(fr)
        ctx.emit_audio(np.concatenate(out), slot=slot)
        return detail

    def _decrypt_ambe(self, bits49: np.ndarray, slot: int,
                      ctx: DecoderContext) -> np.ndarray:
        """ADP/RC4 P2 voice decrypt (reference dsd_mbe.c
        mbeslot_left/right_apply_p25p2_rc4): rckey = 5-byte key ‖ 8-byte
        MI, 7 keystream octets per frame from a rolling absolute drop
        that resets to 256 each superframe."""
        cs = self.crypto[slot]
        if cs["alg"] != 0xAA or cs["mi"] == 0:
            return bits49
        kr = getattr(ctx.state, "keyring", None)
        key = kr.lookup(cs["kid"]) if kr is not None else None
        if key is None:
            return bits49
        from dsdneo_tpu_torch.crypto.keystream import rc4_keystream
        rckey = (int(key) & 0xFFFFFFFFFF).to_bytes(5, "big") \
            + (cs["mi"] & (1 << 64) - 1).to_bytes(8, "big")
        ks = rc4_keystream(rckey, 7, drop=cs["drop"])
        cs["drop"] += 7
        cipher = np.packbits(bits49.astype(np.uint8))
        plain = cipher ^ ks
        return np.unpackbits(plain)[:49]

    def _process_ess(self, x: np.ndarray, slot: int,
                     ctx: DecoderContext) -> str:
        """ESS RS(44,16,29) over GF(64): 16 payload hexbits (ALG 8,
        KID 16, MI 72) collected from the 4V ESS_B fragments + 28 parity
        hexbits from the 2V ESS_A field (reference p25p2_ess_decode,
        ez_rs28_ess).  A successful decode stages ALG/KID/MI for the
        next superframe; the keystream drop resets to 256 either way
        (p25p2_post_2v_reset_crypto_state)."""
        parity_bits = np.concatenate([x[148:244], x[246:318]])
        payload_bits = self.ess_b[slot]
        self.fourv[slot] = 0
        vec = np.zeros(63, dtype=np.int64)
        vec[19:35] = p2_xcch._hexpack(payload_bits)
        vec[35:63] = p2_xcch._hexpack(parity_bits)
        dec, nerr = rs.rs_63_35().decode(vec, erasures=[])
        if nerr < 0:
            # DSD_NEO_P25P2_SOFT_ERASURE_THRESHOLD (docs/cli.md:503):
            # expanded erasure retries on ESS RS failure.  This layer
            # holds hard bits (no per-symbol soft values), so the
            # "weakest-symbol prefix" is a deterministic sliding-window
            # sweep over the parity span — burst damage confined there
            # becomes recoverable; threshold 0 disables (default)
            from dsdneo_tpu_torch.runtime import config as rtcfg
            thr = rtcfg.get().p25p2_soft_erasure_threshold
            for r in range(min(max(thr, 0) // 16, 12)):
                eras = list(range(35 + 2 * r, min(35 + 2 * r + 8, 63)))
                dec2, nerr2 = rs.rs_63_35().decode(vec, erasures=eras)
                if nerr2 >= 0:
                    dec, nerr = dec2, nerr2
                    break
        cs = self.crypto[slot]
        detail = ""
        if 0 <= nerr < 15:
            bits = np.zeros(96, dtype=np.uint8)
            for i in range(16):
                for j in range(6):
                    bits[6 * i + j] = (int(dec[19 + i]) >> (5 - j)) & 1
            alg = _bti(bits[0:8])
            kid = _bti(bits[8:24])
            mi64 = _bti(bits[24:88])
            h1 = _bti(bits[0:32])
            h2 = _bti(bits[32:96])
            detail = f"\n ESS_B {h1:08X}{h2:016X} ERR = {nerr:02d}"
            cs["staged"] = (alg, kid, mi64)
        if cs["staged"] is not None:
            cs["alg"], cs["kid"], cs["mi"] = cs["staged"]
            cs["staged"] = None
        if cs["alg"] == 0xAA:
            cs["drop"] = 256
        return detail

    def _isch(self, ts_bits: np.ndarray, fc: int) -> None:
        """Track superframe position from the ISCH field (reference
        p25p2_process_isch: chan 1 loc 0/1/2 → positions 12/4/8)."""
        word = _bti(ts_bits[320:360])
        if word == p2_xcch.ISCH_SYNC:
            return
        v = p2_xcch.isch_lookup(word)
        if v < 0:
            return
        chan = (v >> 5) & 3
        loc = (v >> 3) & 3
        if chan == 1 and loc in (0, 1, 2):
            self.sf_pos = {0: 0, 1: 4, 2: 8}[loc]

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
