"""Vendor privacy / scrambler keystreams (DMR Tier II radios).

Each scheme produces a static 882-bit keystream (one 18-frame voice
superframe of 49-bit AMBE payloads) applied frame-by-frame with a
rolling counter.  Reference parity: src/crypto/crypt-etc.c
(hytera_bp_apply_frame49, ken_dmr_scrambler_keystream_creation,
anytone_bp_keystream_creation, dmr_parse_static_keystream_spec).

The port's own copy of ``dsdneo_tpu/crypto/vendor.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# default silence frame, 49 bits MSB-first (reference crypt-etc.c packs
# it left-aligned in 56 bits: bit i = const >> (55-i))
AMBE_SILENT_49 = 0xF801A99F8CE080 >> 7


def hytera_bp_keystream(k1: int, k2: int = 0, k3: int = 0, k4: int = 0
                        ) -> np.ndarray:
    """Hytera Basic Privacy: 40/128/256-bit key cycled over 882 bits.

    k2==0 → 40-bit key (k1 high-aligned, period 40); k4!=0 → 256-bit."""
    if k2 == 0:
        length, k1 = 40, (k1 << 24) & 0xFFFFFFFFFFFFFFFF
    elif k4 != 0:
        length = 256
    else:
        length = 128
    tkey = np.zeros(256, dtype=np.uint8)
    for slot, k in enumerate((k1, k2, k3, k4)):
        for i in range(64):
            tkey[64 * slot + i] = (k >> (63 - i)) & 1
    return tkey[np.arange(882) % length]


def kenwood_scrambler_keystream(key15: int) -> np.ndarray:
    """Kenwood DMR 15-bit LFSR scrambler (feedback bits 1^0)."""
    lfsr = key15 & 0x7FFF
    out = np.zeros(882, dtype=np.uint8)
    for i in range(882):
        out[i] = lfsr & 1
        bit = ((lfsr >> 1) ^ lfsr) & 1
        lfsr = (lfsr >> 1) | (bit << 14)
    return out


def anytone_bp_keystream(key16: int) -> np.ndarray:
    """Anytone Basic Privacy: nibble permutation of the 16-bit key
    (nib1/3 inverted, nib2/4 +8 mod 16), repeated."""
    key16 &= 0xFFFF
    nib1 = (~(key16 >> 12)) & 0xF
    nib2 = (((key16 >> 8) & 0xF) + 8) % 16
    nib3 = (~(key16 >> 4)) & 0xF
    nib4 = ((key16 & 0xF) + 8) % 16
    kperm = (nib1 << 12) | (nib2 << 8) | (nib3 << 4) | nib4
    return np.array([(kperm >> (15 - i)) & 1 for i in range(16)],
                    dtype=np.uint8)


@dataclass
class StaticKeystream:
    """Straight mod-XOR keystream spec: arbitrary hex keystream bits with
    modulus and optional per-frame offset/step (reference
    dmr_parse_static_keystream_spec; CLI '-S hex[:mod[:off:step]]')."""
    bits: np.ndarray
    mod: int
    frame_mode: int = 0       # 1 = reset position each frame (off+step)
    frame_off: int = 0
    frame_step: int = 0
    counter: dict = field(default_factory=lambda: {0: 0, 1: 0})

    @classmethod
    def parse(cls, spec: str) -> "StaticKeystream":
        parts = spec.strip().split(":")
        hexs = parts[0]
        raw = bytes.fromhex(hexs if len(hexs) % 2 == 0 else hexs + "0")
        bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
        mod = int(parts[1]) if len(parts) > 1 and parts[1] else len(hexs) * 4
        mod = max(1, min(mod, 882, len(bits) if len(bits) else 1))
        out = np.zeros(882, dtype=np.uint8)
        out[:len(bits[:882])] = bits[:882]
        fm, fo, fs = 0, 0, 0
        if len(parts) > 3:
            fm, fo, fs = 1, int(parts[2] or 0), int(parts[3] or 0)
        return cls(bits=out, mod=mod, frame_mode=fm, frame_off=fo,
                   frame_step=fs)

    def apply_frame49(self, ambe49: np.ndarray, slot: int = 0) -> np.ndarray:
        """XOR one 49-bit AMBE payload; advances the rolling counter.
        Silence frames skip crypto but still advance (reference
        dmr_ambe49_should_skip_crypto + xor_keystream_bits_frame49)."""
        slot &= 1
        v = 0
        for b in ambe49:
            v = (v << 1) | int(b)
        if v == AMBE_SILENT_49:
            self._advance(slot)
            return np.asarray(ambe49, dtype=np.uint8)
        if self.frame_mode:
            pos = (self.frame_off + self.counter[slot] * self.frame_step) % self.mod
        else:
            pos = self.counter[slot] % self.mod
        out = np.asarray(ambe49, dtype=np.uint8).copy()
        for i in range(49):
            out[i] ^= self.bits[pos % self.mod]
            pos += 1
        self._advance(slot, 49)
        return out

    def _advance(self, slot: int, n: int = 49) -> None:
        if self.frame_mode:
            self.counter[slot] += 1
        else:
            self.counter[slot] = (self.counter[slot] + n) % max(self.mod, 1)


def hytera_bp_apply_frame49(ks882: np.ndarray, frame_idx: int,
                            ambe49: np.ndarray) -> np.ndarray:
    """Apply the Hytera BP superframe keystream at voice frame
    ``frame_idx`` (0-17)."""
    frame_idx = max(0, min(frame_idx, 17))
    v = 0
    for b in ambe49:
        v = (v << 1) | int(b)
    if v == AMBE_SILENT_49:
        return np.asarray(ambe49, dtype=np.uint8)
    out = np.asarray(ambe49, dtype=np.uint8).copy()
    out ^= ks882[frame_idx * 49:frame_idx * 49 + 49]
    return out


def csi72_keystream72(key9: bytes) -> np.ndarray:
    """Connect Systems EE72: the 9-byte (72-bit) key XORs the on-air
    interleaved AMBE codeword frame, bytes reversed and the bit stream
    applied back-to-front (reference crypt-csi72.c
    csi72_ambe2_codeword_keystream: ks_bytes[i] = key[8-i];
    interleaved[i] ^= ks_bits[71-i])."""
    if len(key9) != 9:
        raise ValueError("EE72 key must be 9 bytes (72 bits)")
    rev = bytes(key9[8 - i] for i in range(9))
    bits = np.unpackbits(np.frombuffer(rev, dtype=np.uint8))
    return bits[::-1].copy()


def tyt16_keystream72(key16: int, fnum: int) -> np.ndarray:
    """TYT 16-bit Basic: the 2-byte key repeats over 10 bytes; the
    80-bit pattern applies back-to-front onto the interleaved codeword
    frame starting at bit 79 for the first voice frame of a superframe
    and 71 otherwise (reference crypt-tyt.c tyt16_ambe2_codeword_keystream)."""
    ksb = bytes([(key16 >> 8) & 0xFF, key16 & 0xFF]) * 5
    ks = np.unpackbits(np.frombuffer(ksb, dtype=np.uint8))
    idx = 79 if fnum == 0 else 71
    return np.array([ks[idx - i] for i in range(72)], dtype=np.uint8)


# TYT EP wraps the user key in AES-128-OFB under a fixed vendor key
# (reference crypt-tyt.c tyt_ep_aes_keystream_creation static_key)
_TYT_EP_STATIC_KEY = bytes([0x6E, 0x02, 0x8D, 0x8A, 0xCA, 0xEB, 0x9B, 0xBE,
                            0x42, 0x72, 0xFB, 0x82, 0x64, 0x56, 0x31, 0xFA])


def tyt_ep_keystream49(user_key128: int) -> np.ndarray:
    """TYT Enhanced (AES): one AES-128-OFB block keyed by the vendor
    static key with the byte-reversed user key as IV; the first 49
    keystream bits XOR each decoded 49-bit AMBE frame."""
    from dsdneo_tpu_torch.crypto.keystream import aes_ofb_keystream
    ukey = user_key128.to_bytes(16, "big")
    iv = bytes(ukey[15 - i] for i in range(16))
    ks = aes_ofb_keystream(_TYT_EP_STATIC_KEY, iv, 16)
    return np.unpackbits(np.asarray(ks, dtype=np.uint8))[:49].copy()


def kirisun_adv_keystream(user_key32: bytes, mi: int) -> bytes:
    """Kirisun 'advanced' keystream derivation (reference
    crypt-kirisun.c kirisun_adv_keystream_creation): real_key =
    md2ii-32(user_key); state = first 48 bits of
    md2ii-32(mi_be4 ‖ real_key); keystream = the PC4 rolling generator
    over 18 voice frames."""
    from dsdneo_tpu_torch.crypto.pc4 import pc4_kirisun_keystream
    from dsdneo_tpu_torch.crypto.retevis_rc2 import md2ii_hash
    real_key = md2ii_hash(bytes(user_key32[:32]), 32, 32)
    mi_bytes = int(mi).to_bytes(4, "big")
    hash32 = md2ii_hash(mi_bytes + real_key, 32, 32)
    state = 0
    for i in range(6):
        state = (state << 8) | hash32[i]
    return pc4_kirisun_keystream(bytes(user_key32[:32]), state)
