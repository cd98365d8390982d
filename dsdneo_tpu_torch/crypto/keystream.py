"""The voice keystreams of P25 and DMR: RC4 (P25 ADP, DMR ALG 0x21),
DES-OFB, DMR Basic Privacy and AES (OFB and CTR).

The port's own copy of ``rc4_keystream``, ``p25_adp_keystream``, the
DES-OFB generator (``des_encrypt_block``, ``des_ofb_keystream`` and
their helpers), ``DMR_BP_KEYS`` with ``dmr_basic_keystream``, and the
AES block cipher (``aes_encrypt_block``, ``aes_ofb_keystream``,
``aes_ctr_keystream``) of ``dsdneo_tpu/crypto/keystream.py``; host code,
a byte at a time.  The P25 Phase 2 voice path and the serial decoders
(``P25P1Decoder._decrypt_imbe``, ``DmrBsDecoder._synthesize``, the
vendor keystreams of ``crypto.vendor``) call them.
"""

from __future__ import annotations

import numpy as np


def rc4_keystream(key: bytes, n: int, drop: int = 0) -> np.ndarray:
    """``n`` RC4 keystream bytes of ``key`` after discarding the first
    ``drop``, as uint8."""
    s = list(range(256))
    j = 0
    for i in range(256):
        j = (j + s[i] + key[i % len(key)]) & 0xFF
        s[i], s[j] = s[j], s[i]
    out = np.zeros(n, dtype=np.uint8)
    i = j = 0
    for k in range(drop + n):
        i = (i + 1) & 0xFF
        j = (j + s[i]) & 0xFF
        s[i], s[j] = s[j], s[i]
        if k >= drop:
            out[k - drop] = s[(s[i] + s[j]) & 0xFF]
    return out


def p25_adp_keystream(key40: int, mi72: int, n: int = 469,
                      drop: int = 0) -> np.ndarray:
    """P25 ADP (RC4): key = 5-byte key ‖ top 8 bytes of the 72-bit MI
    (reference dsd_mbe.c mbe_apply_p25p1_rc4: rckey[5..12] = the 64-bit
    payload_miP).  ``drop`` is the ABSOLUTE keystream offset, matching
    rc4_voice_decrypt(drop, ...) in crypt-rc4.c:17 — the reference's
    voice path starts at drop=267 (p25p1_hdu.c:429) with NO implicit
    256-byte ADP discard."""
    mi64 = (mi72 >> 8) & ((1 << 64) - 1)
    key = key40.to_bytes(5, "big") + mi64.to_bytes(8, "big")
    return rc4_keystream(key, n, drop=drop)


# -- DMR Basic Privacy (ETSI TS 102 361-3 scrambler) ---------------------
# Published Basic Privacy key list (key ID 1-255 -> 16-bit pattern);
# shared protocol constant, reference copy include/dsd-neo/core/bp.h:11.
DMR_BP_KEYS = (
    0x0000, 0x1F00, 0xE300, 0xFC00, 0x2503, 0x3A03, 0xC603, 0xD903,
    0x4A05, 0x5505, 0xA905, 0xB605, 0x6F06, 0x7006, 0x8C06, 0x9306,
    0x2618, 0x3918, 0xC518, 0xDA18, 0x031B, 0x1C1B, 0xE01B, 0xFF1B,
    0x6C1D, 0x731D, 0x8F1D, 0x901D, 0x491E, 0x561E, 0xAA1E, 0xB51E,
    0x4B28, 0x5428, 0xA828, 0xB728, 0x6E2B, 0x712B, 0x8D2B, 0x922B,
    0x012D, 0x1E2D, 0xE22D, 0xFD2D, 0x242E, 0x3B2E, 0xC72E, 0xD82E,
    0x6D30, 0x7230, 0x8E30, 0x9130, 0x4833, 0x5733, 0xAB33, 0xB433,
    0x2735, 0x3835, 0xC435, 0xDB35, 0x0236, 0x1D36, 0xE136, 0xFE36,
    0x2B49, 0x3449, 0xC849, 0xD749, 0x0E4A, 0x114A, 0xED4A, 0xF24A,
    0x614C, 0x7E4C, 0x824C, 0x9D4C, 0x444F, 0x5B4F, 0xA74F, 0xB84F,
    0x0D51, 0x1251, 0xEE51, 0xF151, 0x2852, 0x3752, 0xCB52, 0xD452,
    0x4754, 0x5854, 0xA454, 0xBB54, 0x6257, 0x7D57, 0x8157, 0x9E57,
    0x6061, 0x7F61, 0x8361, 0x9C61, 0x4562, 0x5A62, 0xA662, 0xB962,
    0x2A64, 0x3564, 0xC964, 0xD664, 0x0F67, 0x1067, 0xEC67, 0xF367,
    0x4679, 0x5979, 0xA579, 0xBA79, 0x637A, 0x7C7A, 0x807A, 0x9F7A,
    0x0C7C, 0x137C, 0xEF7C, 0xF07C, 0x297F, 0x367F, 0xCA7F, 0xD57F,
    0x4D89, 0x5289, 0xAE89, 0xB189, 0x688A, 0x778A, 0x8B8A, 0x948A,
    0x078C, 0x188C, 0xE48C, 0xFB8C, 0x228F, 0x3D8F, 0xC18F, 0xDE8F,
    0x6B91, 0x7491, 0x8891, 0x9791, 0x4E92, 0x5192, 0xAD92, 0xB292,
    0x2194, 0x3E94, 0xC294, 0xDD94, 0x0497, 0x1B97, 0xE797, 0xF897,
    0x06A1, 0x19A1, 0xE5A1, 0xFAA1, 0x23A2, 0x3CA2, 0xC0A2, 0xDFA2,
    0x4CA4, 0x53A4, 0xAFA4, 0xB0A4, 0x69A7, 0x76A7, 0x8AA7, 0x95A7,
    0x20B9, 0x3FB9, 0xC3B9, 0xDCB9, 0x05BA, 0x1ABA, 0xE6BA, 0xF9BA,
    0x6ABC, 0x75BC, 0x89BC, 0x96BC, 0x4FBF, 0x50BF, 0xACBF, 0xB3BF,
    0x66C0, 0x79C0, 0x85C0, 0x9AC0, 0x43C3, 0x5CC3, 0xA0C3, 0xBFC3,
    0x2CC5, 0x33C5, 0xCFC5, 0xD0C5, 0x09C6, 0x16C6, 0xEAC6, 0xF5C6,
    0x84D0, 0x85DF, 0x8AD3, 0x8BDC, 0xB6D5, 0xB7DA, 0xB8D6, 0xB9D9,
    0xD0DA, 0xD1D5, 0xDED9, 0xDFD6, 0xE2DF, 0xE3D0, 0xECDC, 0xEDD3,
    0x2DE8, 0x32E8, 0xCEE8, 0xD1E8, 0x08EB, 0x17EB, 0xEBEB, 0xF4EB,
    0x67ED, 0x78ED, 0x84ED, 0x9BED, 0x42EE, 0x5DEE, 0xA1EE, 0xBEEE,
    0x0BF0, 0x14F0, 0xE8F0, 0xF7F0, 0x2EF3, 0x31F3, 0xCDF3, 0xD2F3,
    0x41F5, 0x5EF5, 0xA2F5, 0xBDF5, 0x64F6, 0x7BF6, 0x87F6, 0x98F6,
)


def dmr_basic_keystream(key_id: int) -> np.ndarray:
    """Basic Privacy 49-bit AMBE keystream for a BP key ID.

    Reference parity (crypt-etc.c dmr_basic_privacy_apply_frame49):
    k = BPK[id]; the 48-bit pattern ((k & 0xFF0F) << 32) | (k << 16) | k
    XORs ambe_d[0..47] MSB-first; bit 48 is left untouched."""
    if not (0 < key_id < 256):
        return np.zeros(49, dtype=np.uint8)
    k = DMR_BP_KEYS[key_id]
    patt = ((k & 0xFF0F) << 32) | (k << 16) | k
    out = np.zeros(49, dtype=np.uint8)
    for j in range(48):
        out[j] = (patt >> (47 - j)) & 1
    return out


# -- DES-OFB (P25 ALGID 0x81) --------------------------------------------
_DES_IP = [58, 50, 42, 34, 26, 18, 10, 2, 60, 52, 44, 36, 28, 20, 12, 4,
           62, 54, 46, 38, 30, 22, 14, 6, 64, 56, 48, 40, 32, 24, 16, 8,
           57, 49, 41, 33, 25, 17, 9, 1, 59, 51, 43, 35, 27, 19, 11, 3,
           61, 53, 45, 37, 29, 21, 13, 5, 63, 55, 47, 39, 31, 23, 15, 7]
_DES_FP = [40, 8, 48, 16, 56, 24, 64, 32, 39, 7, 47, 15, 55, 23, 63, 31,
           38, 6, 46, 14, 54, 22, 62, 30, 37, 5, 45, 13, 53, 21, 61, 29,
           36, 4, 44, 12, 52, 20, 60, 28, 35, 3, 43, 11, 51, 19, 59, 27,
           34, 2, 42, 10, 50, 18, 58, 26, 33, 1, 41, 9, 49, 17, 57, 25]
_DES_E = [32, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 8, 9, 10, 11, 12, 13,
          12, 13, 14, 15, 16, 17, 16, 17, 18, 19, 20, 21, 20, 21, 22, 23,
          24, 25, 24, 25, 26, 27, 28, 29, 28, 29, 30, 31, 32, 1]
_DES_P = [16, 7, 20, 21, 29, 12, 28, 17, 1, 15, 23, 26, 5, 18, 31, 10,
          2, 8, 24, 14, 32, 27, 3, 9, 19, 13, 30, 6, 22, 11, 4, 25]
_DES_PC1 = [57, 49, 41, 33, 25, 17, 9, 1, 58, 50, 42, 34, 26, 18,
            10, 2, 59, 51, 43, 35, 27, 19, 11, 3, 60, 52, 44, 36,
            63, 55, 47, 39, 31, 23, 15, 7, 62, 54, 46, 38, 30, 22,
            14, 6, 61, 53, 45, 37, 29, 21, 13, 5, 28, 20, 12, 4]
_DES_PC2 = [14, 17, 11, 24, 1, 5, 3, 28, 15, 6, 21, 10, 23, 19, 12, 4,
            26, 8, 16, 7, 27, 20, 13, 2, 41, 52, 31, 37, 47, 55, 30, 40,
            51, 45, 33, 48, 44, 49, 39, 56, 34, 53, 46, 42, 50, 36, 29, 32]
_DES_SHIFTS = [1, 1, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 1]
_DES_S = [
    [14,4,13,1,2,15,11,8,3,10,6,12,5,9,0,7,0,15,7,4,14,2,13,1,10,6,12,11,9,5,3,8,
     4,1,14,8,13,6,2,11,15,12,9,7,3,10,5,0,15,12,8,2,4,9,1,7,5,11,3,14,10,0,6,13],
    [15,1,8,14,6,11,3,4,9,7,2,13,12,0,5,10,3,13,4,7,15,2,8,14,12,0,1,10,6,9,11,5,
     0,14,7,11,10,4,13,1,5,8,12,6,9,3,2,15,13,8,10,1,3,15,4,2,11,6,7,12,0,5,14,9],
    [10,0,9,14,6,3,15,5,1,13,12,7,11,4,2,8,13,7,0,9,3,4,6,10,2,8,5,14,12,11,15,1,
     13,6,4,9,8,15,3,0,11,1,2,12,5,10,14,7,1,10,13,0,6,9,8,7,4,15,14,3,11,5,2,12],
    [7,13,14,3,0,6,9,10,1,2,8,5,11,12,4,15,13,8,11,5,6,15,0,3,4,7,2,12,1,10,14,9,
     10,6,9,0,12,11,7,13,15,1,3,14,5,2,8,4,3,15,0,6,10,1,13,8,9,4,5,11,12,7,2,14],
    [2,12,4,1,7,10,11,6,8,5,3,15,13,0,14,9,14,11,2,12,4,7,13,1,5,0,15,10,3,9,8,6,
     4,2,1,11,10,13,7,8,15,9,12,5,6,3,0,14,11,8,12,7,1,14,2,13,6,15,0,9,10,4,5,3],
    [12,1,10,15,9,2,6,8,0,13,3,4,14,7,5,11,10,15,4,2,7,12,9,5,6,1,13,14,0,11,3,8,
     9,14,15,5,2,8,12,3,7,0,4,10,1,13,11,6,4,3,2,12,9,5,15,10,11,14,1,7,6,0,8,13],
    [4,11,2,14,15,0,8,13,3,12,9,7,5,10,6,1,13,0,11,7,4,9,1,10,14,3,5,12,2,15,8,6,
     1,4,11,13,12,3,7,14,10,15,6,8,0,5,9,2,6,11,13,8,1,4,10,7,9,5,0,15,14,2,3,12],
    [13,2,8,4,6,15,11,1,10,9,3,14,5,0,12,7,1,15,13,8,10,3,7,4,12,5,6,11,0,14,9,2,
     7,11,4,1,9,12,14,2,0,6,10,13,15,3,5,8,2,1,14,7,4,10,8,13,15,12,9,0,3,5,6,11],
]


def _permute(val: int, table: list[int], width: int) -> int:
    out = 0
    for pos in table:
        out = (out << 1) | ((val >> (width - pos)) & 1)
    return out


def _des_subkeys(key64: int) -> list[int]:
    cd = _permute(key64, _DES_PC1, 64)
    c = (cd >> 28) & 0xFFFFFFF
    d = cd & 0xFFFFFFF
    keys = []
    for s in _DES_SHIFTS:
        c = ((c << s) | (c >> (28 - s))) & 0xFFFFFFF
        d = ((d << s) | (d >> (28 - s))) & 0xFFFFFFF
        keys.append(_permute((c << 28) | d, _DES_PC2, 56))
    return keys


def _des_f(r: int, k: int) -> int:
    e = _permute(r, _DES_E, 32) ^ k
    out = 0
    for i in range(8):
        chunk = (e >> (42 - 6 * i)) & 0x3F
        row = ((chunk >> 4) & 2) | (chunk & 1)
        col = (chunk >> 1) & 0xF
        out = (out << 4) | _DES_S[i][row * 16 + col]
    return _permute(out, _DES_P, 32)


def des_encrypt_block(block64: int, key64: int) -> int:
    keys = _des_subkeys(key64)
    v = _permute(block64, _DES_IP, 64)
    left, r = (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF
    for k in keys:
        left, r = r, left ^ _des_f(r, k)
    return _permute((r << 32) | left, _DES_FP, 64)


def des_ofb_keystream(key64: int, iv64: int, n_bytes: int) -> np.ndarray:
    out = np.zeros(n_bytes, dtype=np.uint8)
    state = iv64
    pos = 0
    while pos < n_bytes:
        state = des_encrypt_block(state, key64)
        for i in range(8):
            if pos >= n_bytes:
                break
            out[pos] = (state >> (56 - 8 * i)) & 0xFF
            pos += 1
    return out


# -- AES (for AES-256 OFB / AES-128 CTR voice suites) --------------------
_AES_SBOX = None


def _aes_sbox() -> np.ndarray:
    global _AES_SBOX
    if _AES_SBOX is not None:
        return _AES_SBOX
    # generate the AES S-box from GF(2^8) inverses + affine transform
    p = 0x11B
    inv = [0] * 256
    for a in range(1, 256):
        for b in range(1, 256):
            x, y, r = a, b, 0
            aa, bb = a, b
            r = 0
            while bb:
                if bb & 1:
                    r ^= aa
                aa <<= 1
                if aa & 0x100:
                    aa ^= p
                bb >>= 1
            if r == 1:
                inv[a] = b
                break
    sbox = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        x = inv[a] if a else 0
        y = x
        for _ in range(4):
            y = ((y << 1) | (y >> 7)) & 0xFF
            x ^= y
        sbox[a] = x ^ 0x63
    _AES_SBOX = sbox
    return sbox


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) & 0xFF if a & 0x100 else a


def aes_encrypt_block(block: bytes, key: bytes) -> bytes:
    sbox = _aes_sbox()
    nk = len(key) // 4
    nr = {4: 10, 6: 12, 8: 14}[nk]
    # key expansion
    w = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (nr + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = [int(sbox[b]) for b in t]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        elif nk > 6 and i % nk == 4:
            t = [int(sbox[b]) for b in t]
        w.append([w[i - nk][j] ^ t[j] for j in range(4)])

    s = [list(block[i::4]) for i in range(4)]  # state[row][col]

    def add_round_key(rnd):
        for c in range(4):
            for r in range(4):
                s[r][c] ^= w[4 * rnd + c][r]

    def sub_shift_mix(last=False):
        for r in range(4):
            for c in range(4):
                s[r][c] = int(sbox[s[r][c]])
        for r in range(1, 4):
            s[r] = s[r][r:] + s[r][:r]
        if not last:
            for c in range(4):
                a = [s[r][c] for r in range(4)]
                s[0][c] = _xtime(a[0]) ^ _xtime(a[1]) ^ a[1] ^ a[2] ^ a[3]
                s[1][c] = a[0] ^ _xtime(a[1]) ^ _xtime(a[2]) ^ a[2] ^ a[3]
                s[2][c] = a[0] ^ a[1] ^ _xtime(a[2]) ^ _xtime(a[3]) ^ a[3]
                s[3][c] = _xtime(a[0]) ^ a[0] ^ a[1] ^ a[2] ^ _xtime(a[3])

    add_round_key(0)
    for rnd in range(1, nr):
        sub_shift_mix()
        add_round_key(rnd)
    sub_shift_mix(last=True)
    add_round_key(nr)
    return bytes(s[r][c] for c in range(4) for r in range(4))


def aes_ofb_keystream(key: bytes, iv: bytes, n_bytes: int) -> np.ndarray:
    out = np.zeros(n_bytes, dtype=np.uint8)
    state = iv
    pos = 0
    while pos < n_bytes:
        state = aes_encrypt_block(state, key)
        take = min(16, n_bytes - pos)
        out[pos:pos + take] = np.frombuffer(state[:take], dtype=np.uint8)
        pos += take
    return out


def aes_ctr_keystream(key: bytes, iv: bytes, n_bytes: int) -> np.ndarray:
    out = np.zeros(n_bytes, dtype=np.uint8)
    ctr = int.from_bytes(iv, "big")
    pos = 0
    while pos < n_bytes:
        block = aes_encrypt_block(ctr.to_bytes(16, "big"), key)
        take = min(16, n_bytes - pos)
        out[pos:pos + take] = np.frombuffer(block[:take], dtype=np.uint8)
        ctr = (ctr + 1) & ((1 << 128) - 1)
        pos += take
    return out
