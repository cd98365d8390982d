"""P25 Phase 1 IMBE voice frame ECC: interleave, PN descramble, FEC.

A 144-bit voice frame carries 8 code vectors: u0-u3 Golay(23,12),
u4-u6 Hamming(15,11), u7 raw 7 bits → 88 parameter bits.  Vectors
u1-u6 are scrambled by the IMBE PN sequence seeded from the corrected
u0.  The dibit interleave schedule is the P25 CAI table (reference copy
at include/dsd-neo/protocol/p25/p25p1_const.h).

STATUS: fully validated against the reference fixtures.  The PN
sequence (pr[n] = 173*pr[n-1] + 13849 mod 2^16, output = MSB, seeded
with 16x the value of corrected-u0 codeword bits [22..11]) and its
reversed per-word application order were recovered empirically from
the p25p1_c4fm_vc fixture by inverting the seed space against the
Golay codebook; with them u1-u3 decode at ~0.02 avg corrections per
word.  The u4-u6 Hamming(15,11) parity-check space was learned the
same way (rank-4 span of >97%-agreement parity vectors over the
descrambled words).

The port's own copy of ``dsdneo_tpu/protocol/p25/imbe_frame.py``
(numpy only).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from dsdneo_tpu_torch.fec import gf
from dsdneo_tpu_torch.fec.blockcodes import MLBlockCode

IMBE_W = [0,2,4,1,3,5,0,2,4,1,3,6,0,2,4,1,3,6,0,2,4,1,3,6,
          0,2,4,1,3,6,0,2,4,1,3,6,0,2,5,1,3,6,0,2,5,1,3,6,
          0,2,5,1,3,7,0,2,5,1,3,7,0,2,5,1,4,7,0,3,5,2,4,7]
IMBE_X = [22,20,10,20,18,0,20,18,8,18,16,13,18,16,6,16,14,11,
          16,14,4,14,12,9,14,12,2,12,10,7,12,10,0,10,8,5,
          10,8,13,8,6,3,8,6,11,6,4,1,6,4,9,4,2,6,
          4,2,7,2,0,4,2,0,5,0,13,2,0,21,3,21,11,0]
IMBE_Y = [1,3,5,0,2,4,1,3,6,0,2,4,1,3,6,0,2,4,1,3,6,0,2,4,
          1,3,6,0,2,4,1,3,6,0,2,5,1,3,6,0,2,5,1,3,6,0,2,5,
          1,3,6,0,2,5,1,3,7,0,2,5,1,4,7,0,3,5,2,4,7,1,3,5]
IMBE_Z = [21,19,1,21,19,9,19,17,14,19,17,7,17,15,12,17,15,5,
          15,13,10,15,13,3,13,11,8,13,11,1,11,9,6,11,9,14,
          9,7,4,9,7,12,7,5,2,7,5,10,5,3,0,5,3,8,
          3,1,5,3,1,6,1,14,3,1,22,4,22,12,1,22,20,2]


@lru_cache(maxsize=None)
def golay_23_12() -> MLBlockCode:
    """Perfect binary Golay(23,12,7), generator 0xAE3, data-first."""
    cb = gf.systematic_codebook(0b101011100011, 23, 12)
    return MLBlockCode(cb, 23, 12, "Golay(23,12,7)")


def _pn_bits(seed12: int, n: int) -> np.ndarray:
    pr = 16 * seed12
    out = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        pr = (173 * pr + 13849) & 0xFFFF
        out[i] = pr >> 15
    return out


# IMBE Hamming(15,11) parity checks, learned from fixture voice frames
# (4-dim span; 15-bit masks over the received word, MSB = bit 0)
_IMBE_H15 = (0b000100001111111, 0b001001110001111,
             0b010010110110011, 0b100011011010101)


@lru_cache(maxsize=1)
def _imbe_h15_syndromes() -> dict:
    """syndrome (4 bits) → single-error position, for the learned code."""
    table = {}
    for pos in range(15):
        s = 0
        for r, h in enumerate(_IMBE_H15):
            s |= (((h >> (14 - pos)) & 1) << r)
        table[s] = pos
    assert len(table) == 15 and 0 not in table
    return table


def _imbe_hamming_decode(word15: np.ndarray) -> tuple[np.ndarray, int]:
    """→ (corrected 15-bit word, corrections 0/1)."""
    v = 0
    for b in word15:
        v = (v << 1) | int(b)
    s = 0
    for r, h in enumerate(_IMBE_H15):
        s |= (bin(v & h).count("1") & 1) << r
    if s == 0:
        return np.asarray(word15, dtype=np.uint8), 0
    out = np.asarray(word15, dtype=np.uint8).copy()
    pos = _imbe_h15_syndromes().get(s)
    if pos is None:
        return out, 2          # uncorrectable double error
    out[pos] ^= 1
    return out, 1


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def imbe_h15_matrix() -> np.ndarray:
    """The learned parity-check masks as a 4x15 GF(2) matrix.  Columns
    0-3 form a (permuted) identity: the code is systematic with parity
    at positions 0-3 and data at positions 4-14."""
    return np.array([[(h >> (14 - p)) & 1 for p in range(15)]
                     for h in _IMBE_H15], dtype=np.uint8)


def _imbe_hamming_encode(data11: np.ndarray) -> np.ndarray:
    """11 data bits (positions 4-14) → 15-bit codeword (solve the 4
    parity bits at positions 0-3; the parity columns are a permuted
    identity so the solution is direct)."""
    d = np.asarray(data11, dtype=np.uint8)
    M = imbe_h15_matrix()
    b = (M[:, 4:] @ d) % 2
    word = np.zeros(15, dtype=np.uint8)
    word[4:] = d
    for r in range(4):
        col = int(np.flatnonzero(M[r, :4])[0])
        word[col] = b[r]
    return word


@lru_cache(maxsize=1)
def _golay_seedkey_lut() -> np.ndarray:
    """codeword-bits-[11..22]-value → message index (positions 11-22 are
    an information set of the Golay(23,12); verified exhaustive)."""
    g23 = golay_23_12()
    lut = np.zeros(4096, dtype=np.int32)
    for m in range(4096):
        c = g23.codebook[m]
        key = 0
        for i in range(12):
            key |= int(c[11 + i]) << i
        lut[key] = m
    return lut


def _row_param_bits(c: np.ndarray) -> list[int]:
    """Golay codeword → its 12 parameter bits, MSB-first.

    RECOVERED CONVENTION (fixture-validated): the parameter bits of each
    Golay vector are codeword bits [22..11] — the same 12-bit value that
    seeds the PN scrambler (û0); under it the fixtures' b0/gain/voicing
    fields show clean significance ramps and smooth tracks, which the
    data-first message bits do not."""
    return [int(c[22 - i]) for i in range(12)]


def encode_imbe_ecc(bits88: np.ndarray) -> np.ndarray:
    """88 recovered-layout parameter bits → 144 on-air bits (inverse of
    ``decode_imbe_ecc``; used by tests and loopback tooling)."""
    b = np.asarray(bits88, dtype=np.uint8)
    g23 = golay_23_12()
    lut = _golay_seedkey_lut()
    fr = np.zeros((8, 23), dtype=np.uint8)

    def golay_from_param(bits12) -> np.ndarray:
        key = 0
        for i in range(12):
            key |= int(bits12[11 - i]) << i       # param MSB = c[22]
        return g23.codebook[int(lut[key])]

    c0 = golay_from_param(b[0:12])
    fr[0] = c0
    foo = 0
    for k in range(12):
        foo |= int(c0[11 + k]) << k
    pn = _pn_bits(foo, 114)
    pos, k = 0, 12
    for row in range(1, 4):
        fr[row] = golay_from_param(b[k:k + 12]) ^ pn[pos:pos + 23][::-1]
        k += 12
        pos += 23
    for row in range(4, 7):
        cw = _imbe_hamming_encode(b[k:k + 11][::-1])   # param MSB = w[14]
        k += 11
        fr[row][:15] = cw ^ pn[pos:pos + 15][::-1]
        pos += 15
    fr[7][:7] = b[k:k + 7][::-1]                       # param MSB = fr7[6]
    bits144 = np.zeros(144, dtype=np.uint8)
    for j in range(72):
        bits144[2 * j] = fr[IMBE_W[j]][IMBE_X[j]]
        bits144[2 * j + 1] = fr[IMBE_Y[j]][IMBE_Z[j]]
    return bits144


def decode_imbe_ecc(bits144: np.ndarray) -> tuple[np.ndarray, int]:
    """144 on-air bits → (88 parameter bits, bit error count).

    Output layout: û0..û3 contribute codeword bits [22..11] MSB-first
    (12 each), û4..û6 bits [14..4] (11 each), û7 reversed (7, the frame
    sync bit last) — the recovered parameter basis consumed by
    dsdneo_tpu_torch.vocoder.imbe.decode_frame."""
    fr = np.zeros((8, 23), dtype=np.uint8)
    b = np.asarray(bits144, dtype=np.uint8)
    for j in range(72):
        fr[IMBE_W[j]][IMBE_X[j]] = b[2 * j]
        fr[IMBE_Y[j]][IMBE_Z[j]] = b[2 * j + 1]
    return decode_imbe_fr(fr)


def decode_imbe_fr(fr: np.ndarray) -> tuple[np.ndarray, int]:
    """ECC-decode an already de-interleaved 8x23 IMBE frame matrix
    (the reference's ``char imbe_fr[8][23]`` convention; YSF wide/full
    rate voice hands the matrix over directly)."""
    g23 = golay_23_12()
    errs = 0

    u0, e0 = g23.decode(fr[0])
    errs += e0
    # PN seed: corrected-u0 codeword bits [22..11] as a 12-bit value
    # (LSB = c[11]), scaled by 16
    c0 = g23.codebook[u0]
    foo = 0
    for k in range(12):
        foo |= int(c0[11 + k]) << k
    pn = _pn_bits(foo, 114)
    pos = 0
    out = np.zeros(88, dtype=np.uint8)
    out[0:12] = _row_param_bits(c0)
    k = 12
    for row in range(1, 4):
        # PN applies in reverse bit order within each code vector
        word = fr[row] ^ pn[pos:pos + 23][::-1]
        pos += 23
        m, e = g23.decode(word)
        errs += e
        out[k:k + 12] = _row_param_bits(g23.codebook[m])
        k += 12
    for row in range(4, 7):
        word = fr[row][:15] ^ pn[pos:pos + 15][::-1]
        pos += 15
        corrected, e = _imbe_hamming_decode(word)
        errs += e
        out[k:k + 11] = corrected[14:3:-1]
        k += 11
    out[k:k + 7] = fr[7][6::-1]
    return out, errs
