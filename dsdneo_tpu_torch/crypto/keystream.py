"""The voice keystreams of P25: RC4 (ADP) and DES-OFB.

The port's own copy of ``rc4_keystream``, ``p25_adp_keystream`` and the
DES-OFB generator (``des_encrypt_block``, ``des_ofb_keystream`` and
their helpers) of ``dsdneo_tpu/crypto/keystream.py``; host code, a byte
at a time.  The P25 Phase 2 voice path and the Phase 1 serial decoder
(``P25P1Decoder._decrypt_imbe``) call them.
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
