"""PC5 cipher (Baofeng AP voice privacy).

The nibble-width sibling of PC4 (reference src/crypto/crypt-pc5.c):
the same MD2-variant + ARC4/SplitMix64 key schedule (23000-output
warm-up) deals 253 16-element round permutations, nibble substitution
tables, per-round rotations (mod 11 + 1) and two round-key arrays plus
a 25-bit tail mask.  Each 49-bit frame XORs the tail mask over bits
24-48 and runs its first 24 bits (six nibbles) through a 254-round
3+3-nibble Feistel with the same dropped-final-swap double-buffer
discipline as PC4.

The port's own copy of ``dsdneo_tpu/crypto/pc5.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.crypto.retevis_rc2 import _Arc4SplitMix, md2ii_hash

NBROUND = 254
N1 = 264


def _rol12(x: int, n: int) -> int:
    x &= 0xFFF
    return ((x << n) | (x >> (12 - n))) & 0xFFF


def _ror12(x: int, n: int) -> int:
    x &= 0xFFF
    return ((x >> n) | (x << (12 - n))) & 0xFFF


class PC5:
    def __init__(self, key_material: bytes, rounds: int = NBROUND):
        self.rounds = rounds
        h4 = md2ii_hash(key_material, N1, N1)
        x = 0
        for i in range(8):
            x = (x << 8) | h4[256 + i]
        rng = _Arc4SplitMix(h4[:256], x)
        for _ in range(23000):
            rng.output()

        def discard():
            for _ in range(rng.output() + 256):
                rng.output()

        def shuffle(count: int) -> list[int]:
            nums = list(range(count))
            for i in range(count - 1, 0, -1):
                j = rng.output() % (i + 1)
                nums[j], nums[i] = nums[i], nums[j]
            return nums

        # perm[value][round_column]: 253 columns of 16-element perms
        self.perm = [[0] * 253 for _ in range(16)]
        for w in range(253):
            discard()
            col = shuffle(16)
            for i in range(16):
                self.perm[i][w] = col[i]
        discard()
        # new1 is a 256-slot table with only the first 16 shuffled; the
        # mixing value can reach 31 and reads the zero tail (the
        # reference's static-storage zeros)
        self.new1 = shuffle(16) + [0] * 240
        discard()
        self.decal = [(rng.output() % 11) + 1 for _ in range(rounds)]
        discard()
        self.rngxor = [[0] * 3 for _ in range(rounds)]
        for w in range(3):
            for i in range(rounds):
                self.rngxor[i][w] = rng.output() % 16
        discard()
        self.tab = shuffle(16)
        self.inv = [0] * 16
        for i, v in enumerate(self.tab):
            self.inv[v] = i
        discard()
        self.permut = []
        for _ in range(3):
            discard()
            self.permut.append(shuffle(3))
        discard()
        self.rngxor2 = [[0] * 3 for _ in range(rounds)]
        for w in range(3):
            for i in range(rounds):
                self.rngxor2[i][w] = rng.output() % 16
        # 25-bit OTA tail mask (one RNG byte consumed first)
        rng.output()
        self.tail = np.array([rng.output() % 2 for _ in range(25)],
                             dtype=np.uint8)

    def _compute(self, tab1: list[int], col: int) -> list[int]:
        tot = []
        for w in range(3):
            v = ((self.perm[tab1[self.permut[w][0]]][col]
                  + self.perm[tab1[self.permut[w][1]]][col]) & 0xFF) \
                ^ self.perm[tab1[self.permut[w][2]]][col]
            tot.append((v + self.new1[v]) % 16)
        return tot

    # -- 6-nibble block cipher (dropped-final-swap double buffers) ------
    def _decrypt_block(self, nib6: list[int]) -> list[int]:
        l = [list(nib6[:3]), [0, 0, 0]]
        r = [list(nib6[3:]), [0, 0, 0]]
        y = (self.rounds - 1) % 253 or 253
        for i in range(1, self.rounds + 1):
            a, b = (i - 1) % 2, i % 2
            y -= 1
            tot = self._compute(r[a], y)
            if y == 0:
                y = 253
            ll = l[a]
            ll[0] = self.inv[(ll[0] ^ self.rngxor[self.rounds - i][0]) & 0xF]
            ll[1] = self.tab[(ll[1] + self.rngxor[self.rounds - i][1]) & 0xF]
            ll[2] = self.inv[(ll[2] ^ self.rngxor[self.rounds - i][2]) & 0xF]
            res = _ror12((ll[0] << 8) | (ll[1] << 4) | ll[2],
                         self.decal[self.rounds - i])
            ll[0], ll[1], ll[2] = res >> 8, (res >> 4) & 0xF, res & 0xF
            ll[0] = (ll[0] + 16 - (~self.rngxor2[i - 1][0] & 0xF)) & 0xF
            ll[1] = (ll[1] ^ (~self.rngxor2[i - 1][1] & 0xFF)) & 0xF
            ll[2] = (ll[2] + 16 - (~self.rngxor2[i - 1][2] & 0xF)) & 0xF
            ra = r[a]
            l[b] = ra[:]
            r[b] = [(ll[0] + tot[0]) & 0xF, (ll[1] ^ tot[1]) & 0xF,
                    (ll[2] + tot[2]) & 0xF]
        prev = (self.rounds - 1) % 2
        return r[prev] + l[prev]

    def _encrypt_block(self, nib6: list[int]) -> list[int]:
        l = [list(nib6[:3]), [0, 0, 0]]
        r = [list(nib6[3:]), [0, 0, 0]]
        for i in range(1, self.rounds + 1):
            a, b = (i - 1) % 2, i % 2
            rr = r[a]
            rr[0] = (rr[0] + (~self.rngxor2[self.rounds - i][0] & 0xF)) & 0xF
            rr[1] = (rr[1] ^ (~self.rngxor2[self.rounds - i][1] & 0xFF)) & 0xF
            rr[2] = (rr[2] + (~self.rngxor2[self.rounds - i][2] & 0xF)) & 0xF
            res = _rol12((rr[0] << 8) | (rr[1] << 4) | rr[2],
                         self.decal[i - 1])
            rr[0], rr[1], rr[2] = res >> 8, (res >> 4) & 0xF, res & 0xF
            rr[0] = (self.tab[rr[0]] ^ self.rngxor[i - 1][0]) & 0xF
            rr[1] = (self.inv[rr[1]] + 16 - self.rngxor[i - 1][1]) & 0xF
            rr[2] = (self.tab[rr[2]] ^ self.rngxor[i - 1][2]) & 0xF
            tot = self._compute(rr, (i - 1) % 253)
            la = l[a]
            l[b] = rr[:]
            r[b] = [(la[0] + 16 - tot[0]) & 0xF, (la[1] ^ tot[1]) & 0xF,
                    (la[2] + 16 - tot[2]) & 0xF]
        prev = (self.rounds - 1) % 2
        return r[prev] + l[prev]

    # -- 49-bit frame API -------------------------------------------------
    @staticmethod
    def _nibbles(bits24: np.ndarray) -> list[int]:
        out = []
        for q in range(6):
            v = 0
            for k in range(4):
                v |= int(bits24[q * 4 + k]) << (3 - k)
            out.append(v)
        return out

    @staticmethod
    def _bits(nib6: list[int]) -> np.ndarray:
        out = np.zeros(24, dtype=np.uint8)
        for q in range(6):
            for k in range(4):
                out[q * 4 + k] = (nib6[q] >> (3 - k)) & 1
        return out

    def decrypt_frame49(self, bits49: np.ndarray) -> np.ndarray:
        b = np.asarray(bits49, dtype=np.uint8).copy()
        b[24:49] ^= self.tail
        b[:24] = self._bits(self._decrypt_block(self._nibbles(b[:24])))
        return b

    def encrypt_frame49(self, bits49: np.ndarray) -> np.ndarray:
        b = np.asarray(bits49, dtype=np.uint8).copy()
        b[:24] = self._bits(self._encrypt_block(self._nibbles(b[:24])))
        b[24:49] ^= self.tail
        return b

    @classmethod
    def from_hex(cls, hexstr: str) -> "PC5":
        """Baofeng AP key parse (crypt-pc5.c): 32 hex chars → reversed
        raw bytes; 64 hex chars → the ASCII text."""
        hexstr = hexstr.strip().upper()
        if len(hexstr) == 64:
            return cls(hexstr.encode())
        if len(hexstr) == 32:
            raw = bytes.fromhex(hexstr)
            return cls(bytes(raw[15 - i] for i in range(16)))
        raise ValueError("Baofeng AP key must be 32 or 64 hex characters")
