"""PC4 cipher (TYT AP voice privacy; also the PC5/Kirisun base).

A vendor cipher with no public specification, reconstructed from the
reference's behavior (src/crypto/crypt-pc4.c): all tables are DERIVED
from the key — a generalized-MD2 digest keys the ARC4+SplitMix64 RNG
(shared with Retevis RC2, dsdneo_tpu_torch.crypto.retevis_rc2), which deals
16 round S-box permutations, a 256-entry substitution + inverse, two
49-bit frame permutations, 254 rotation amounts and two 254x3 round-key
arrays.  Each 49-bit AMBE frame is permuted, its first 48 bits run
through a 254-round 3+3-byte unbalanced Feistel (add/xor/rotate/sub
rounds with a keyed mixing function), bit 48 XORed with the running
parity byte, and permuted back.

The port's own copy of ``dsdneo_tpu/crypto/pc4.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.crypto.retevis_rc2 import _Arc4SplitMix, md2ii_hash

NBROUND = 254
N1 = 264


def _rol24(x: int, n: int) -> int:
    x &= 0xFFFFFF
    return ((x << n) | (x >> (24 - n))) & 0xFFFFFF


def _ror24(x: int, n: int) -> int:
    x &= 0xFFFFFF
    return ((x >> n) | (x << (24 - n))) & 0xFFFFFF


class PC4:
    def __init__(self, key_material: bytes, rounds: int = NBROUND):
        self.rounds = rounds
        h4 = md2ii_hash(key_material, N1, N1)
        x = 0
        for i in range(8):
            x = (x << 8) | h4[256 + i]
        rng = _Arc4SplitMix(h4[:256], x)
        for _ in range(20000):
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

        self.perm = []
        for _ in range(16):
            discard()
            self.perm.append(shuffle(256))
        discard()
        self.new1 = shuffle(256)
        discard()
        self.array = shuffle(49)
        discard()
        self.decal = [(rng.output() % 23) + 1 for _ in range(rounds)]
        discard()
        self.rngxor = [[0] * 3 for _ in range(rounds)]
        for w in range(3):
            for i in range(rounds):
                self.rngxor[i][w] = rng.output()
        discard()
        self.array2 = shuffle(49)
        discard()
        self.tab = shuffle(256)
        self.inv = [0] * 256
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
                self.rngxor2[i][w] = rng.output()

    # -- the keyed mixing function ------------------------------------
    def _compute(self, tab1: list[int], rnd: int) -> list[int]:
        tot = []
        for w in range(3):
            p = self.perm[rnd]
            v = ((p[tab1[self.permut[w][0]]] + p[tab1[self.permut[w][1]]])
                 & 0xFF) ^ p[tab1[self.permut[w][2]]]
            tot.append((v + self.new1[v]) & 0xFF)
        return tot

    # -- 6-byte block cipher -------------------------------------------
    # The reference keeps l/r as 2-slot double buffers and transforms the
    # previous slot IN PLACE; the output reads slot (rounds-1)%2, so the
    # final round contributes only its in-place transform — its swap is
    # discarded.  The buffers below mirror that exactly.
    def _encrypt_block(self, block6: list[int]) -> tuple[list[int], int]:
        l = [list(block6[:3]), [0, 0, 0]]
        r = [list(block6[3:]), [0, 0, 0]]
        totb = 0
        for i in range(1, self.rounds + 1):
            a, b = (i - 1) % 2, i % 2
            rr = r[a]
            totb ^= rr[0] ^ rr[1] ^ rr[2]
            rr[0] = (rr[0] + (~self.rngxor2[self.rounds - i][0] & 0xFF)) & 0xFF
            rr[1] = rr[1] ^ (~self.rngxor2[self.rounds - i][1] & 0xFF)
            rr[2] = (rr[2] + (~self.rngxor2[self.rounds - i][2] & 0xFF)) & 0xFF
            res = _rol24((rr[0] << 16) | (rr[1] << 8) | rr[2],
                         self.decal[i - 1])
            rr[0], rr[1], rr[2] = res >> 16, (res >> 8) & 0xFF, res & 0xFF
            rr[0] = self.tab[rr[0]] ^ self.rngxor[i - 1][0]
            rr[1] = (self.inv[rr[1]] - self.rngxor[i - 1][1]) & 0xFF
            rr[2] = self.tab[rr[2]] ^ self.rngxor[i - 1][2]
            tot = self._compute(rr, (i - 1) % 16)
            la = l[a]
            l[b] = rr[:]
            r[b] = [(la[0] - tot[0]) & 0xFF, la[1] ^ tot[1],
                    (la[2] - tot[2]) & 0xFF]
        prev = (self.rounds - 1) % 2
        return r[prev] + l[prev], totb & 1

    def _decrypt_block(self, block6: list[int]) -> tuple[list[int], int]:
        l = [list(block6[:3]), [0, 0, 0]]
        r = [list(block6[3:]), [0, 0, 0]]
        totb = 0
        y = (self.rounds - 1) % 16 or 16
        for i in range(1, self.rounds + 1):
            a, b = (i - 1) % 2, i % 2
            y -= 1
            tot = self._compute(r[a], y)
            if y == 0:
                y = 16
            ll = l[a]
            ll[0] = self.inv[ll[0] ^ self.rngxor[self.rounds - i][0]]
            ll[1] = self.tab[(ll[1] + self.rngxor[self.rounds - i][1]) & 0xFF]
            ll[2] = self.inv[ll[2] ^ self.rngxor[self.rounds - i][2]]
            res = _ror24((ll[0] << 16) | (ll[1] << 8) | ll[2],
                         self.decal[self.rounds - i])
            ll[0], ll[1], ll[2] = res >> 16, (res >> 8) & 0xFF, res & 0xFF
            ll[0] = (ll[0] - (~self.rngxor2[i - 1][0] & 0xFF)) & 0xFF
            ll[1] = ll[1] ^ (~self.rngxor2[i - 1][1] & 0xFF)
            ll[2] = (ll[2] - (~self.rngxor2[i - 1][2] & 0xFF)) & 0xFF
            totb ^= ll[0] ^ ll[1] ^ ll[2]
            ra = r[a]
            l[b] = ra[:]
            r[b] = [(ll[0] + tot[0]) & 0xFF, ll[1] ^ tot[1],
                    (ll[2] + tot[2]) & 0xFF]
        prev = (self.rounds - 1) % 2
        return r[prev] + l[prev], totb & 1

    # -- 49-bit frame API -----------------------------------------------
    @staticmethod
    def _pack48(bits: np.ndarray) -> list[int]:
        out = []
        for q in range(6):
            b = 0
            for k in range(8):
                b |= int(bits[q * 8 + k]) << (7 - k)
            out.append(b)
        return out

    @staticmethod
    def _unpack48(bytes6: list[int]) -> np.ndarray:
        out = np.zeros(48, dtype=np.uint8)
        for q in range(6):
            for k in range(8):
                out[q * 8 + k] = (bytes6[q] >> (7 - k)) & 1
        return out

    def decrypt_frame49(self, bits49: np.ndarray) -> np.ndarray:
        """pc4_tyt_decrypt_frame49: array2 permute → block decrypt →
        bit48 ^= parity → inverse array permute."""
        b = np.asarray(bits49, dtype=np.uint8)
        t = b[self.array2]
        blk, totb = self._decrypt_block(self._pack48(t[:48]))
        mid = np.concatenate([self._unpack48(blk),
                              [(int(t[48]) ^ totb) & 1]]).astype(np.uint8)
        out = np.zeros(49, dtype=np.uint8)
        out[self.array] = mid
        return out

    def encrypt_frame49(self, bits49: np.ndarray) -> np.ndarray:
        """Exact inverse of decrypt_frame49 (tests/loopback)."""
        b = np.asarray(bits49, dtype=np.uint8)
        mid = b[self.array]                       # undo the final scatter
        blk, totb = self._encrypt_block(self._pack48(mid[:48]))
        t = np.concatenate([self._unpack48(blk),
                            [(int(mid[48]) ^ totb) & 1]]).astype(np.uint8)
        out = np.zeros(49, dtype=np.uint8)
        out[self.array2] = t
        return out

    @classmethod
    def from_hex(cls, hexstr: str) -> "PC4":
        """TYT AP key parse (crypt-tyt.c tyt_ap_pc4_keystream_creation):
        64 hex chars key the cipher with the ASCII text; 32 hex chars
        with the byte-reversed 16 raw bytes."""
        hexstr = hexstr.strip().upper()
        if len(hexstr) == 64:
            return cls(hexstr.encode())
        if len(hexstr) == 32:
            raw = bytes.fromhex(hexstr)
            return cls(bytes(raw[15 - i] for i in range(16)))
        raise ValueError("TYT AP key must be 32 or 64 hex characters")


def pc4_kirisun_keystream(key32: bytes, initial_state48: int) -> bytes:
    """Kirisun rolling keystream (reference crypt-pc4.c
    pc4_kirisun_generate_keystream): 18 frames of 6 PC4-encrypted state
    bytes (+1 gap byte), the 48-bit state rotating left by one between
    frames."""
    pc = PC4(key32)
    out = bytearray(126)
    state = initial_state48 & 0xFFFFFFFFFFFF
    k = 0
    for _ in range(18):
        blk = [(state >> (40 - 8 * i)) & 0xFF for i in range(6)]
        enc, _totb = pc._encrypt_block(blk)
        state = 0
        for b in enc:
            state = (state << 8) | b
        state = ((state << 1) | (state >> 47)) & 0xFFFFFFFFFFFF
        for b in enc:
            out[k] = b
            k += 1
        k += 1          # gap byte stays zero
    return bytes(out)
