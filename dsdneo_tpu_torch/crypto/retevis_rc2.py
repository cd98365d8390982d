"""Retevis AP (RC2) voice privacy.

The vendor scheme layers three primitives (reference src/crypto/
crypt-rc2.c + md2ii.c; no public spec exists, the construction is
understood from the reference's behavior):

  1. a generalized MD2 digest (RFC 1319 structure with a vendor S-box
     and a 264-byte block) hashes the user key into 264 bytes;
  2. an ARC4 keystream keyed by the first 256 digest bytes, with each
     output byte combined (alternating XOR/ADD) with a SplitMix64
     stream seeded from the last 8 digest bytes, warmed up 22000+
     outputs, derives the 64-word RC2 key and a 64-bit initial state;
  3. per 49-bit AMBE frame, the RC2 block cipher (RFC 2268 mixing
     rounds with mashes at rounds 4 and 10) iterates a 64-bit chaining
     state whose LSB decrypts each voice bit from bit 48 down to 0,
     the state rotating left and absorbing the ciphertext bit.

Validated by self-roundtrip (encrypt == decrypt: the per-bit XOR chain
is an involution given the same key/state) and structural tests; no
fixture traffic exists to cross-check.

The port's own copy of ``dsdneo_tpu/crypto/retevis_rc2.py`` (numpy
only), unchanged in its logic, so both packages give the same results
bit for bit.
"""

from __future__ import annotations

import numpy as np

MD2II_BLOCK = 264

_MD2II_SBOX = bytes((
    13, 199, 11, 67, 237, 193, 164, 77, 115, 184, 141, 222, 73, 38, 147, 36,
    150, 87, 21, 104, 12, 61, 156, 101, 111, 145, 119, 22, 207, 35, 198, 37,
    171, 167, 80, 30, 219, 28, 213, 121, 86, 29, 214, 242, 6, 4, 89, 162,
    110, 175, 19, 157, 3, 88, 234, 94, 144, 118, 159, 239, 100, 17, 182, 173,
    238, 68, 16, 79, 132, 54, 163, 52, 9, 58, 57, 55, 229, 192, 170, 226,
    56, 231, 187, 158, 70, 224, 233, 245, 26, 47, 32, 44, 247, 8, 251, 20,
    197, 185, 109, 153, 204, 218, 93, 178, 212, 137, 84, 174, 24, 120, 130, 149,
    72, 180, 181, 208, 255, 189, 152, 18, 143, 176, 60, 249, 27, 227, 128, 139,
    243, 253, 59, 123, 172, 108, 211, 96, 138, 10, 215, 42, 225, 40, 81, 65,
    90, 25, 98, 126, 154, 64, 124, 116, 122, 5, 1, 168, 83, 190, 131, 191,
    244, 240, 235, 177, 155, 228, 125, 66, 43, 201, 248, 220, 129, 188, 230, 62,
    75, 71, 78, 34, 31, 216, 254, 136, 91, 114, 106, 46, 217, 196, 92, 151,
    209, 133, 51, 236, 33, 252, 127, 179, 69, 7, 183, 105, 146, 97, 39, 15,
    205, 112, 200, 166, 223, 45, 48, 246, 186, 41, 148, 140, 107, 76, 85, 95,
    194, 142, 50, 49, 134, 23, 135, 169, 221, 210, 203, 63, 165, 82, 161, 202,
    53, 14, 206, 232, 103, 102, 195, 117, 250, 99, 0, 74, 160, 241, 2, 113,
))


def md2ii_hash(data: bytes, block_len: int = MD2II_BLOCK,
               out_len: int = MD2II_BLOCK) -> bytes:
    """Generalized MD2: state/X buffer of 3*block_len, checksum block,
    (block_len+2)-round transform, pad-with-padlen + checksum absorb."""
    h1 = bytearray(3 * block_len)
    h2 = bytearray(block_len)
    checksum = 0
    buffered = 0

    def transform():
        nonlocal buffered
        t = 0
        for rnd in range(block_len + 2):
            for i in range(3 * block_len):
                h1[i] ^= _MD2II_SBOX[t]
                t = h1[i]
            t = (t + rnd) & 0xFF
        buffered = 0

    def update(chunk: bytes):
        nonlocal checksum, buffered
        pos = 0
        while pos < len(chunk):
            while pos < len(chunk) and buffered < block_len:
                byte = chunk[pos]; pos += 1
                off = buffered; buffered += 1
                h1[off + block_len] = byte
                h1[off + 2 * block_len] = byte ^ h1[off]
                h2[off] ^= _MD2II_SBOX[byte ^ checksum]
                checksum = h2[off]
            if buffered == block_len:
                transform()

    update(data)
    pad = block_len - buffered
    update(bytes([pad & 0xFF]) * pad)   # C truncates the pad byte to uint8
    update(bytes(h2))
    return bytes(h1[:out_len])


class _Arc4SplitMix:
    """The reference's modified ARC4: PRGA output combined with a
    SplitMix64 byte stream, alternating XOR / ADD."""

    def __init__(self, key256: bytes, x64: int):
        s = list(range(256))
        j = 0
        for i in range(256):
            j = (j + s[i] + key256[i % 256]) & 0xFF
            s[i], s[j] = s[j], s[i]
        self.s = s
        self.i = 0
        self.j = 0
        self.x = x64 & 0xFFFFFFFFFFFFFFFF
        self.bb = 0
        self.xyz = 0
        self.count = 0

    def _splitmix(self) -> int:
        self.x = (self.x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = self.x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)

    def output(self) -> int:
        s = self.s
        self.i = (self.i + 1) & 0xFF
        self.j = (self.j + s[self.i]) & 0xFF
        s[self.i], s[self.j] = s[self.j], s[self.i]
        t = (s[self.i] + s[self.j]) & 0xFF
        if self.xyz == 0:
            self.bb = self._splitmix()
        rnd = (self.bb >> (56 - 8 * self.xyz)) & 0xFF
        self.xyz = (self.xyz + 1) % 8
        if self.count == 0:
            rnd ^= s[t]
            self.count = 1
        else:
            rnd = (rnd + s[t]) & 0xFF
            self.count = 0
        return rnd


def rc2_encrypt_block(plain8: bytes, xkey: list[int]) -> bytes:
    """RC2 (RFC 2268) encryption: 16 mixing iterations with mashes after
    rounds 4 and 10, little-endian 16-bit words."""
    x10 = plain8[0] | (plain8[1] << 8)
    x32 = plain8[2] | (plain8[3] << 8)
    x54 = plain8[4] | (plain8[5] << 8)
    x76 = plain8[6] | (plain8[7] << 8)
    M = 0xFFFF
    for i in range(16):
        x10 = (x10 + ((x32 & ~x76) & M) + (x54 & x76) + xkey[4 * i]) & M
        x10 = ((x10 << 1) | (x10 >> 15)) & M
        x32 = (x32 + ((x54 & ~x10) & M) + (x76 & x10) + xkey[4 * i + 1]) & M
        x32 = ((x32 << 2) | (x32 >> 14)) & M
        x54 = (x54 + ((x76 & ~x32) & M) + (x10 & x32) + xkey[4 * i + 2]) & M
        x54 = ((x54 << 3) | (x54 >> 13)) & M
        x76 = (x76 + ((x10 & ~x54) & M) + (x32 & x54) + xkey[4 * i + 3]) & M
        x76 = ((x76 << 5) | (x76 >> 11)) & M
        if i in (4, 10):
            x10 = (x10 + xkey[x76 & 63]) & M
            x32 = (x32 + xkey[x10 & 63]) & M
            x54 = (x54 + xkey[x32 & 63]) & M
            x76 = (x76 + xkey[x54 & 63]) & M
    return bytes([x10 & 0xFF, x10 >> 8, x32 & 0xFF, x32 >> 8,
                  x54 & 0xFF, x54 >> 8, x76 & 0xFF, x76 >> 8])


class RetevisRC2:
    """Key setup + per-frame keystream (reference create_keys_rc2 /
    decrypt_rc2)."""

    def __init__(self, key_material: bytes):
        h4 = md2ii_hash(key_material)
        x = 0
        for i in range(8):
            x = (x << 8) | h4[256 + i]
        rng = _Arc4SplitMix(h4[:256], x)
        for _ in range(22000):
            rng.output()
        for _ in range(rng.output() + 256):
            rng.output()
        self.xkey = [((rng.output() << 8) | rng.output()) for _ in range(64)]
        for _ in range(rng.output() + 256):
            rng.output()
        z = 0
        for _ in range(8):
            z = (z << 8) | rng.output()
        self.internal_zero = z

    @classmethod
    def from_hex(cls, hexstr: str) -> "RetevisRC2":
        """Key parse per the reference: a 64-hex key hashes its ASCII
        text; a 32-hex key hashes the byte-REVERSED 16 raw bytes."""
        hexstr = hexstr.strip().upper()
        if len(hexstr) == 64:
            return cls(hexstr.encode())
        if len(hexstr) == 32:
            raw = bytes.fromhex(hexstr)
            return cls(bytes(raw[15 - i] for i in range(16)))
        raise ValueError("Retevis AP key must be 32 or 64 hex characters")

    def _walk(self, bits49: np.ndarray, absorb_output: bool) -> np.ndarray:
        """One 49-bit frame through the chaining cipher, bit 48 first.
        The chain absorbs the CIPHERTEXT bit each step: on decrypt that
        is the input bit, on encrypt the output bit."""
        out = np.asarray(bits49, dtype=np.uint8).copy()
        state = self.internal_zero
        for sso in range(49):
            cipher = rc2_encrypt_block(
                bytes((state >> (56 - 8 * k)) & 0xFF for k in range(8)),
                self.xkey)
            state = 0
            for b in cipher:
                state = (state << 8) | b
            inbit = int(out[48 - sso]) & 1
            outbit = inbit ^ (state & 1)
            out[48 - sso] = outbit
            absorbed = outbit if absorb_output else inbit
            state = ((state << 1) | (state >> 63)) & 0xFFFFFFFFFFFFFFFF
            state = (state & ~1) | absorbed
        return out

    def decrypt_frame49(self, bits49: np.ndarray) -> np.ndarray:
        """Reference decrypt_rc2: the input IS the ciphertext."""
        return self._walk(bits49, absorb_output=False)

    def encrypt_frame49(self, bits49: np.ndarray) -> np.ndarray:
        return self._walk(bits49, absorb_output=True)
