"""Yaesu System Fusion (C4FM 4800 baud) decoder.

Frame: 480 symbols / 100 ms — sync(20 dibits) + FICH(100 dibits) +
payload(360 dibits = 5 blocks).  FICH: 5×20 dibit de-interleave →
rate-1/2 K=5 Viterbi → 4× Golay(24,12) → 32 info bits + CRC16.
V/D type 2 blocks: 20 DCH dibits + 52 voice dibits per block; the five
DCH pieces form a second Viterbi+CRC16 channel carrying callsign text
(whitened with the PN9 x⁹+x⁵+1 sequence, seed 0x1C9).
Reference parity: src/protocol/ysf/ysf.c, ysf_frame.c.

The port's own copy of ``dsdneo_tpu/protocol/ysf/decoder.py`` (numpy
only), unchanged in its logic, so both packages give the same results
bit for bit; the voice frames synthesize on ``ctx.device``.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import blockcodes, conv
from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                      ProtocolDecoder, register)
from dsdneo_tpu_torch.symbols.framesync import SyncHit

_PN95_SEED = 0x1C9


def _pn95_bits(n: int) -> np.ndarray:
    lfsr = _PN95_SEED
    out = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        out[i] = lfsr & 1
        fb = ((lfsr >> 4) ^ lfsr) & 1
        lfsr = (lfsr >> 1) | (fb << 8)
    return out


_PN95_512 = _pn95_bits(512)


def ysf_crc16(bits: np.ndarray) -> int:
    """17-bit shift-register CRC16 form: 0 ⇒ valid over data‖crc
    (reference ysf.c ysf_crc16)."""
    poly = (1 << 12) + (1 << 5) + 1
    crc = 0
    for b in bits:
        crc = ((crc << 1) | int(b)) & 0x1FFFF
        if crc & 0x10000:
            crc = (crc & 0xFFFF) ^ poly
    return (crc ^ 0xFFFF) & 0xFFFF


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _dibits_to_bits(dd: np.ndarray) -> np.ndarray:
    bits = np.empty(2 * len(dd), dtype=np.uint8)
    bits[0::2] = (dd >> 1) & 1
    bits[1::2] = dd & 1
    return bits


def _ascii(by) -> str:
    return "".join(chr(int(c)) if 0x20 <= c <= 0x7E else " " for c in by)


DT_NAMES = {0: "V/D1 ", 1: "DATA ", 2: "V/D2 ", 3: "VWFR "}
CM_NAMES = {0: "Group/CQ ", 1: "RID Mode ", 2: "Res: 2   ", 3: "Private  "}
FI_NAMES = {0: "HC ", 1: "CC ", 2: "TC ", 3: "XX "}


@register("ysf")
class YsfDecoder(ProtocolDecoder):
    protocol = "ysf"

    def _dd(self, reader: DibitReader, start: int, n: int) -> np.ndarray | None:
        if start < 0 or start + n > len(reader.dibits):
            return None
        dd = reader.dibits[start:start + n].astype(np.uint8)
        if reader.invert:
            dd = dd ^ 2
        return dd

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        pos = hit.pos
        fich_dd = self._dd(reader, pos + 20, 100)
        if fich_dd is None:
            return len(reader.dibits)
        line = f"Sync: {hit.sync.name}  "
        fich = self._fich(fich_dd)
        if fich is None:
            ctx.emit(line + "FICH (CRC ERR) ", "ysf", pos)
            return pos + 480
        fi, cm, bn, bt, fn, ft, mr, vp, dt, sc = fich
        line += DT_NAMES.get(dt, "")
        line += CM_NAMES.get(cm, "")
        line += "Repeater " if vp else "-Simplex "
        line += FI_NAMES.get(fi, "")
        line += f"FN: {fn + 1}/{ft + 1} "
        detail = ""
        payload = self._dd(reader, pos + 120, 360)
        if payload is not None and fi == 1 and dt == 2:
            detail = self._dch2(payload, fn, cm, ctx)
        if payload is not None and dt == 2 and fi == 1:
            # FI gate like every other voice path here: header (HC)
            # and terminator (TC) frames carry CSD, not VCH — without
            # it each V/D2 call starts and ends with a garbage burst
            self._voice_vd2(payload, ctx)
        if payload is not None and dt == 0 and fi == 1:
            self._voice_vd1(payload, ctx)
        if payload is not None and dt == 3 and fi == 1:
            self._voice_fr(payload, fn, ft, ctx)
        ctx.emit(line + detail, "ysf", pos, dt=dt, fn=fn, cm=cm)
        return pos + 480

    def _fich(self, fich_dd: np.ndarray):
        # dibit de-interleave: block 5 × depth 20
        buf = np.zeros(100, dtype=np.uint8)
        for i in range(20):
            for j in range(5):
                buf[j + i * 5] = fich_dd[i + j * 20]
        sym = _dibits_to_bits(buf).astype(np.float32)
        dec = conv.decode_soft(sym, nbits=96)
        gol = blockcodes.golay_24_12()
        fich48 = np.zeros(48, dtype=np.uint8)
        for i in range(4):
            msg, errs = gol.decode(dec[i * 24:(i + 1) * 24])
            if errs > 3:
                return None
            fich48[i * 12:(i + 1) * 12] = gol.codebook[msg][:12]
        if ysf_crc16(fich48) != 0:
            return None
        f = fich48
        return (_bti(f[0:2]), _bti(f[4:6]), _bti(f[6:8]), _bti(f[8:10]),
                _bti(f[10:13]), _bti(f[13:16]), _bti(f[18:21]), int(f[21]),
                _bti(f[22:24]), _bti(f[25:32]))

    def _dch2(self, payload: np.ndarray, fn: int, cm: int,
              ctx: DecoderContext) -> str:
        dch = np.concatenate([payload[i * 72:i * 72 + 20] for i in range(5)])
        buf = np.zeros(100, dtype=np.uint8)
        for i in range(20):
            for j in range(5):
                buf[j + i * 5] = dch[i + j * 20]
        sym = _dibits_to_bits(buf).astype(np.float32)
        dec = conv.decode_soft(sym, nbits=96)
        if ysf_crc16(dec[:96]) != 0:
            return "DCH2 (CRC ERR) "
        bits = dec[:80] ^ _PN95_512[:80]
        by = [_bti(bits[i * 8:(i + 1) * 8]) for i in range(10)]
        txt = _ascii(by)
        if fn == 0:
            if cm != 1:
                return f"DST: {txt} "
            return f"DST RID: {txt[:5]} SRC RID: {txt[5:]} "
        if fn == 1:
            ctx.state.last_src = txt.strip()
            return f"SRC: {txt}"
        if fn == 2:
            return f"U/L: {txt}"
        if fn == 3:
            return f"D/L: {txt}"
        if fn == 4:
            return f"RM1: {txt[:5]} RM2: {txt[5:]} "
        if fn == 5:
            return f"RM3: {txt[:5]} RM4: {txt[5:]} "
        return ""


    def _voice_fr(self, payload: np.ndarray, fn: int, ft: int,
                  ctx: DecoderContext) -> None:
        """VWFR (dt 3) wide/full-rate voice: 5 slots of 72 VCH dibits
        (2 slots after a 216-dibit DCH block on the CSD3 frame, ft==1
        fn==0), each a P25-style IMBE 7200x4400 codeword (reference
        ysf.c ysf_handle_full_rate_voice / ysf_decode_full_rate_voice
        _slot -> processMbeFrame)."""
        from dsdneo_tpu_torch.protocol.p25.imbe_frame import decode_imbe_fr
        from dsdneo_tpu_torch.vocoder.mbe import decode_imbe_4400
        from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
        is_csd3 = ft == 1 and fn == 0
        start = 216 if is_csd3 else 0
        n_slots = 2 if is_csd3 else 5
        params = []
        prev = getattr(ctx.state, "ysf_fr_prev", None)
        for i in range(n_slots):
            seg = payload[start + 72 * i:start + 72 * (i + 1)]
            if len(seg) < 72:
                break
            bits88, _errs = decode_imbe_fr(_fr_slot_to_matrix(seg))
            prev = decode_imbe_4400(bits88, prev=prev)
            params.append(prev)
        ctx.state.ysf_fr_prev = prev
        if params:
            pcm = synthesize_frames(params, ctx.device)
            if pcm.size:
                ctx.emit_audio(pcm, slot=0)

    def _voice_vd1(self, payload: np.ndarray, ctx: DecoderContext) -> None:
        """V/D1 voice: 5 blocks of 36 DCH + 36 VCH dibits; each VCH is
        a 72-bit AMBE codeword through the standard 2450 ECC (the same
        Golay/PN frame NXDN and DMR carry — reference ysf.c ysf_ehr
        over dsd_ambe_2450_dibit_map)."""
        from dsdneo_tpu_torch.protocol.dmr.ambe_frame import decode_ambe_ecc
        from dsdneo_tpu_torch.vocoder.mbe import decode_ambe_2450
        from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
        params = []
        for blk in range(4):        # reference ysf_ehr(vbuf, 0, 4):
            # the 5th VCH slot is not voice on V/D1 systems
            seg = payload[blk * 72 + 36: blk * 72 + 72]
            bits72 = np.empty(72, dtype=np.uint8)
            bits72[0::2] = (seg >> 1) & 1
            bits72[1::2] = seg & 1
            bits49, _errs = decode_ambe_ecc(bits72)
            params.append(decode_ambe_2450(bits49))
        pcm = synthesize_frames(params, ctx.device)
        if pcm.size:
            ctx.emit_audio(pcm, slot=0)

    def _voice_vd2(self, payload: np.ndarray, ctx: DecoderContext) -> None:
        """V/D2 voice: 5 blocks of 52 dibits after each 20-dibit DCH
        chunk; 104 bits de-interleaved (4x26) + PN-dewhitened, with
        tripled-bit majority vote for the protected prefix → 49-bit AMBE
        (reference src/protocol/ysf/ysf.c ysf_read_type2_vech_bits /
        ysf_build_type2_ambe)."""
        from dsdneo_tpu_torch.vocoder.mbe import decode_ambe_2450
        from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
        maj = np.array([0, 0, 0, 1, 0, 1, 1, 1], dtype=np.uint8)
        params = []
        for blk in range(5):
            seg = payload[blk * 72 + 20: blk * 72 + 72]
            bits = np.empty(104, dtype=np.uint8)
            k = 0
            for d in seg:
                for b in ((d >> 1) & 1, d & 1):
                    idx = (k % 4) * 26 + k // 4
                    bits[idx] = b ^ _PN95_512[idx % 512]
                    k += 1
            ambe = np.zeros(49, dtype=np.uint8)
            li = 0
            for j in range(2, 81, 3):
                ambe[li] = maj[(bits[j - 2] << 2) | (bits[j - 1] << 1) | bits[j]]
                li += 1
            ambe[27:49] = bits[81:103]
            params.append(decode_ambe_2450(ambe))
        pcm = synthesize_frames(params, ctx.device)
        if pcm.size:
            ctx.emit_audio(pcm, slot=0)


# full-rate voice slot interleave (reference ysf_frame.c
# DSD_YSF_FR_INTERLEAVE)
_FR_INTERLEAVE = np.array([
    0, 7, 12, 19, 24, 31, 36, 43, 48, 55, 60, 67, 72, 79, 84, 91, 96,
    103, 108, 115, 120, 127, 132, 139,
    1, 6, 13, 18, 25, 30, 37, 42, 49, 54, 61, 66, 73, 78, 85, 90, 97,
    102, 109, 114, 121, 126, 133, 138,
    2, 9, 14, 21, 26, 33, 38, 45, 50, 57, 62, 69, 74, 81, 86, 93, 98,
    105, 110, 117, 122, 129, 134, 141,
    3, 8, 15, 20, 27, 32, 39, 44, 51, 56, 63, 68, 75, 80, 87, 92, 99,
    104, 111, 116, 123, 128, 135, 140,
    4, 11, 16, 23, 28, 35, 40, 47, 52, 59, 64, 71, 76, 83, 88, 95, 100,
    107, 112, 119, 124, 131, 136, 143,
    5, 10, 17, 22, 29, 34, 41, 46, 53, 58, 65, 70, 77, 82, 89, 94, 101,
    106, 113, 118, 125, 130, 137, 142], dtype=np.int64)

_FR_ROW_LENS = (23, 23, 23, 23, 15, 15, 15, 7)


def _fr_slot_to_matrix(seg72: np.ndarray) -> np.ndarray:
    """72 VCH dibits → the 8x23 IMBE frame matrix (reference
    dsd_ysf_unpack_full_rate_imbe: de-interleave then fill each row
    from its top bit down)."""
    raw = np.empty(144, dtype=np.uint8)
    raw[0::2] = (seg72 >> 1) & 1
    raw[1::2] = seg72 & 1
    vch = raw[_FR_INTERLEAVE]
    fr = np.zeros((8, 23), dtype=np.uint8)
    k = 0
    for n, mlen in enumerate(_FR_ROW_LENS):
        for m in range(mlen - 1, -1, -1):
            fr[n][m] = vch[k]
            k += 1
    return fr
