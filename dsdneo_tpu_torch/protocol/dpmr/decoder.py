"""dPMR (ETSI TS 102 658, 2400 sym/s 4-level FSK) decoder.

FS2 voice superframe part after the 12-symbol sync:
  CCH1(36 dib) TCH(4×36 dib) CC(12 dib) CCH2(36 dib) TCH(4×36 dib)

CCH: descramble (x⁹+x⁵+1 LFSR, seed 0x1FF) → 12×6 de-interleave →
6× Hamming(12,8) → 48 bits (FN 2, ID-half 12, mode 3, version 2,
format 2, …, CRC7).  The 24-bit called/calling AI IDs assemble from two
consecutive frames' ID halves and render as base-11 7-digit strings.
Reference parity: src/protocol/dpmr/dpmr_voice.c, dpmr_data.c.

The port's own copy of ``dsdneo_tpu/protocol/dpmr/decoder.py`` (numpy
only), unchanged in its logic, so both packages give the same results
bit for bit; the voice frames synthesize on ``ctx.device``.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import blockcodes
from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                      ProtocolDecoder, register)
from dsdneo_tpu_torch.symbols.framesync import SyncHit


def _scramble_bits(n: int) -> np.ndarray:
    """x⁹+x⁵+1 LFSR keystream, seed 0x1FF (ETSI TS 102 658 7.4)."""
    shift = [(0x1FF >> i) & 1 for i in range(9)]
    out = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        out[i] = shift[0]
        fb = shift[4] ^ shift[0]
        shift = shift[1:] + [fb]
    return out


_SCRAMBLE_72 = _scramble_bits(72)
# 12×6 de-interleave: output[j*12+i] = input[i*6+j]
_DEINT_6x12 = np.array([(k % 12) * 6 + k // 12 for k in range(72)], dtype=np.int64)


def crc7_dpmr(bits: np.ndarray) -> int:
    sr = 0
    for b in bits:
        if ((sr >> 6) & 1) ^ int(b):
            sr = ((sr << 1) ^ 0x09) & 0x7F
        else:
            sr = (sr << 1) & 0x7F
    return sr


def air_interface_id(ai_id: int) -> str:
    """24-bit AI ID → 7-digit base-11 string (digit 10 = '*')."""
    digits = []
    rem = ai_id
    for div in (1464100, 146410, 14641, 1331, 121, 11, 1):
        d = rem // div
        rem = rem % div
        digits.append("*" if d == 10 else str(d))
    return "".join(digits)


# ETSI TS 102 658 6.1.5.2.2 channel code → color code table
_CC_MAP = {
    0x575F77: 0, 0x577577: 1, 0x57DD75: 2, 0x57F775: 3, 0x55577D: 4,
    0x557D7D: 5, 0x55D57F: 6, 0x55FF7F: 7, 0x5F555F: 8, 0x5F7F5F: 9,
    0x5FD75D: 10, 0x5FFD5D: 11, 0x5D5D55: 12, 0x5D7755: 13, 0x5DDF57: 14,
    0x5DF557: 15, 0x775DD7: 16, 0x7777D7: 17, 0x77DFD5: 18, 0x77F5D5: 19,
    0x7555DD: 20, 0x757FDD: 21, 0x75D7DF: 22, 0x75FDDF: 23, 0x7F57FF: 24,
    0x7F7DFF: 25, 0x7FD5FD: 26, 0x7FFFFD: 27, 0x7D5FF5: 28, 0x7D75F5: 29,
    0x7DDDF7: 30, 0x7DF7F7: 31, 0xD755F7: 32, 0xD77FF7: 33, 0xD7D7F5: 34,
    0xD7FDF5: 35, 0xD55DFD: 36, 0xD577FD: 37, 0xD5DFFF: 38, 0xD5F5FF: 39,
    0xDF5FDF: 40, 0xDF75DF: 41, 0xDFDDDD: 42, 0xDFF7DD: 43, 0xDD57D5: 44,
    0xDD7DD5: 45, 0xDDD5D7: 46, 0xDDFFD7: 47, 0xF75757: 48, 0xF77D57: 49,
    0xF7D555: 50, 0xF7FF55: 51, 0xF55F5D: 52, 0xF5755D: 53, 0xF5DD5F: 54,
    0xF5F75F: 55, 0xFF5D7F: 56, 0xFF777F: 57, 0xFFDF7D: 58, 0xFFF57D: 59,
    0xFD5575: 60, 0xFD7F75: 61, 0xFDD777: 62, 0xFDFD77: 63,
}


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


@register("dpmr")
class DpmrDecoder(ProtocolDecoder):
    protocol = "dpmr"

    def __init__(self):
        self.tg: str | None = None
        self.src: str | None = None
        self.color_code: int | None = None

    def _bits(self, reader: DibitReader, start: int, n_dib: int) -> np.ndarray | None:
        if start < 0 or start + n_dib > len(reader.dibits):
            return None
        dd = reader.dibits[start:start + n_dib].astype(np.uint8)
        if reader.invert:
            dd = dd ^ 2
        bits = np.empty(2 * n_dib, dtype=np.uint8)
        bits[0::2] = (dd >> 1) & 1
        bits[1::2] = dd & 1
        return bits

    def _cch(self, bits72: np.ndarray):
        """→ (48 corrected bits, hamming_ok[6], crc_ok)"""
        d = bits72 ^ _SCRAMBLE_72
        deint = d[_DEINT_6x12]
        ham = blockcodes.hamming_12_8()
        data = np.zeros(48, dtype=np.uint8)
        ok = []
        for j in range(6):
            msg, errs = ham.decode(deint[j * 12:(j + 1) * 12])
            ok.append(errs <= 1)
            data[j * 8:(j + 1) * 8] = ham.codebook[msg][:8]
        crc_ok = crc7_dpmr(data[:41]) == _bti(data[41:48])
        return data, ok, crc_ok

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        pos = hit.end
        if hit.sync.kind == "fs1":
            ctx.emit(f"Sync: {hit.sync.name}  dPMR Frame Sync 1 (header)", "dpmr", hit.pos)
            return pos
        if hit.sync.kind == "fs4":
            ctx.emit(f"Sync: {hit.sync.name}  dPMR Frame Sync 4 (end)", "dpmr", hit.pos)
            return pos
        if hit.sync.kind == "fs3":
            # FS3 doubles as the channel-code field of the superframe's
            # second frame: the part began one frame (192 dibits) earlier
            pos = hit.pos - 192 + 12
            if pos < 12:
                return hit.end

        cch1 = self._bits(reader, pos, 36)
        cc_bits = self._bits(reader, pos + 36 + 144, 12)
        cch2 = self._bits(reader, pos + 36 + 144 + 12, 36)
        if cch1 is None or cc_bits is None or cch2 is None:
            return len(reader.dibits)

        d1, h1, c1 = self._cch(cch1)
        d2, h2, c2 = self._cch(cch2)
        fn1, fn2 = _bti(d1[0:2]), _bti(d2[0:2])
        id_value = (_bti(d1[2:14]) << 12) | _bti(d2[2:14])
        strong = ((c1 or (h1[0] and h1[1])) and (c2 or (h2[0] and h2[1])))

        code = _bti(cc_bits) | 0x555555
        if code in _CC_MAP:
            self.color_code = _CC_MAP[code]

        if strong:
            ident = air_interface_id(id_value)
            if (c1 or h1[0]) and fn1 == 0 or (c2 or h2[0]) and fn2 == 1:
                self.tg = ident
            elif (c1 or h1[0]) and fn1 == 2 or (c2 or h2[0]) and fn2 == 3:
                self.src = ident

        # TCH voice: 4 AMBE frames per frame, two frames per part
        for base in (pos + 36, pos + 36 + 144 + 12 + 36):
            self._voice(reader, base, ctx)

        line = f"Sync: {hit.sync.name}  dPMR Frame Sync 2 \n"
        line += f" TG={self.tg}" if self.tg else " TG=(CRC ERR)"
        if self.src:
            line += f" Src={self.src}"
            if self.color_code is not None:
                line += f" Channel Code={self.color_code:02d}"
        else:
            line += " Src=(CRC ERR) Channel Code =(CRC ERR)"
        ctx.emit(line, "dpmr", hit.pos, fn=(fn1, fn2))
        return pos + 372

    def _voice(self, reader: DibitReader, start: int, ctx: DecoderContext) -> None:
        """4 AMBE+2 frames of 36 dibits each (reference
        src/protocol/dpmr/dpmr_voice.c dpmr_read_tch_group)."""
        from dsdneo_tpu_torch.protocol.dmr.ambe_frame import decode_ambe_ecc
        from dsdneo_tpu_torch.vocoder.mbe import decode_ambe_2450
        from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
        params = []
        for k in range(4):
            bits = self._bits(reader, start + 36 * k, 36)
            if bits is None:
                return
            bits49, _errs = decode_ambe_ecc(bits)
            params.append(decode_ambe_2450(bits49))
        pcm = synthesize_frames(params, ctx.device)
        if pcm.size:
            ctx.emit_audio(pcm, slot=0)
