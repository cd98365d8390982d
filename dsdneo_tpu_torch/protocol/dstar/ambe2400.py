"""D-STAR AMBE 3600x2400 voice-frame ECC — recovered, round 3.

A 72-bit D-STAR voice frame carries the same four code vectors as the
AMBE+2 3600x2450 frame (protocol/dmr/ambe_frame.py): C0 Golay, C1
Golay(23,12) PN-scrambled from the corrected C0, C2 11 raw bits, C3 14
raw bits → 49 parameter bits.  Two conventions differ from DMR:

* the on-air interleave is the D-STAR w/x schedule (protocol constant,
  reference include/dsd-neo/protocol/dstar/dstar_const.h
  dstar_interleave_w/x — the reference's src/protocol/dstar/dstar.c:36
  fills ambe_fr[4][24] with it before handing mbelib the frame);
* C0 is the EXTENDED Golay(24,12) with the overall parity at
  fr[0][0] and the Golay(23,12) codeword at fr[0][1:24] (DMR puts the
  parity last).  The C1 PN seed reads fr[0] bits [12..24) LSB-first —
  physically the same slots as DMR's seed.

RECOVERY EVIDENCE (PARITY.md "D-STAR AMBE-2400 ECC recovered"): the
structure was derived blind from the fixture's 99 off-air frames
before consulting the reference table — GF(2) nullspace analysis finds
a 12-dim dual space on exactly 24 positions whose weight enumerator
{8:759, 12:2576, 16:759, 24:1} is the extended Golay's; same-C0 frame
XOR pairs expose the C1 Golay on the residue-(2,4,7,9) pair set; the
reference w/x table then matches the algebra exactly, and the full
chain decodes ALL 99 frames with ZERO corrections (random floor ≈ 2.4
per Golay).

The 49 parameter bits remain VQ/delta-coded (DVSI codebooks): plain
binary pitch/gain fields provably do NOT fit (per-bit flip rates ~0.5
even across voiced-to-voiced frame pairs; all 44 silence frames
distinct), so voice PCM synthesis stays out of scope — the recovered
layer yields FEC-validated parameter frames, per-frame error counts,
and the band-voicing/activity field at bits [42:46].

The port's own copy of ``dsdneo_tpu/protocol/dstar/ambe2400.py`` (numpy
only), unchanged in its logic, so both packages give the same results
bit for bit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from dsdneo_tpu_torch.protocol.p25.imbe_frame import golay_23_12, _pn_bits

# D-STAR AMBE interleave schedule (reference dstar_const.h
# dstar_interleave_w / dstar_interleave_x): on-air bit i → fr[W[i]][X[i]]
DSTAR_W = [
    0, 0, 3, 2, 1, 1, 0, 0, 1, 1, 0, 0, 3, 2, 1, 1, 3, 2, 1, 1, 0, 0, 3, 2,
    0, 0, 3, 2, 1, 1, 0, 0, 1, 1, 0, 0, 3, 2, 1, 1, 3, 2, 1, 1, 0, 0, 3, 2,
    0, 0, 3, 2, 1, 1, 0, 0, 1, 1, 0, 0, 3, 2, 1, 1, 3, 3, 2, 1, 0, 0, 3, 3,
]
DSTAR_X = [
    10, 22, 11, 9, 10, 22, 11, 23, 8, 20, 9, 21, 10, 8, 9, 21, 8, 6, 7, 19,
    8, 20, 9, 7, 6, 18, 7, 5, 6, 18, 7, 19, 4, 16, 5, 17, 6, 4, 5, 17, 4, 2,
    3, 15, 4, 16, 5, 3, 2, 14, 3, 1, 2, 14, 3, 15, 0, 12, 1, 13, 2, 0, 1,
    13, 0, 12, 10, 11, 0, 12, 1, 13,
]


@lru_cache(maxsize=1)
def _row_positions():
    """Per-row stream positions ordered by in-row bit index x:
    fr[r][x] = bits72[ROW[r][x]]."""
    rows = []
    for r, n in ((0, 24), (1, 23), (2, 11), (3, 14)):
        pos = np.full(n, -1, dtype=np.int64)
        for i in range(72):
            if DSTAR_W[i] == r and DSTAR_X[i] < n:
                pos[DSTAR_X[i]] = i
        assert (pos >= 0).all()
        rows.append(pos)
    return rows


def _seed12(cw0: np.ndarray) -> int:
    """C1 PN seed: fr[0] bits [12..24) LSB-first = Golay codeword bits
    [11..23) of the C0 word (data LSB + 11 parity bits)."""
    foo = 0
    for k in range(12):
        foo |= int(cw0[11 + k]) << k
    return foo


def deinterleave_dstar72(bits72: np.ndarray) -> list[np.ndarray]:
    """72 on-air bits → [fr0(24), fr1(23), fr2(11), fr3(14)]."""
    b = np.asarray(bits72, dtype=np.uint8)
    return [b[pos] for pos in _row_positions()]


def decode_dstar_ambe_ecc(bits72: np.ndarray) -> tuple[np.ndarray, int]:
    """72 on-air bits → (49 AMBE parameter bits, error count).

    Zero-error on every voice frame of the off-air dstar fixture
    (tests/test_dstar_ambe.py)."""
    fr0, fr1, fr2, fr3 = deinterleave_dstar72(bits72)
    g23 = golay_23_12()
    c0, e0 = g23.decode(fr0[1:24])
    errs = e0
    cw0 = g23.codebook[c0]
    if (int(cw0.sum()) & 1) != int(fr0[0]):
        errs += 1                       # extended-Golay parity mismatch
    pn = _pn_bits(_seed12(cw0), 23)
    c1, e1 = g23.decode(fr1 ^ pn[::-1])
    errs += e1
    out = np.zeros(49, dtype=np.uint8)
    out[0:12] = [(c0 >> (11 - i)) & 1 for i in range(12)]
    out[12:24] = [(c1 >> (11 - i)) & 1 for i in range(12)]
    out[24:35] = fr2
    out[35:49] = fr3
    return out, errs


def encode_dstar_ambe_ecc(bits49: np.ndarray) -> np.ndarray:
    """49 AMBE parameter bits → 72 on-air bits (inverse of
    ``decode_dstar_ambe_ecc``; tests/loopback tooling)."""
    b = np.asarray(bits49, dtype=np.uint8)
    g23 = golay_23_12()
    m0 = 0
    for i in range(12):
        m0 = (m0 << 1) | int(b[i])
    cw0 = g23.codebook[m0]
    fr0 = np.zeros(24, dtype=np.uint8)
    fr0[0] = int(cw0.sum()) & 1
    fr0[1:24] = cw0
    pn = _pn_bits(_seed12(cw0), 23)
    m1 = 0
    for i in range(12):
        m1 = (m1 << 1) | int(b[12 + i])
    fr1 = g23.codebook[m1] ^ pn[::-1]
    rows = [fr0, fr1, b[24:35], b[35:49]]
    out = np.zeros(72, dtype=np.uint8)
    for r, pos in enumerate(_row_positions()):
        out[pos] = rows[r]
    return out


def voicing_activity(bits49: np.ndarray) -> int:
    """Empirical band-voicing/activity field, bits [42:46) LSB-first:
    0 on every fixture silence frame, 8-15 during speech (the only
    plain-coded field — see module docstring)."""
    b = np.asarray(bits49, dtype=np.uint8)
    return int(b[42] | (b[43] << 1) | (b[44] << 2) | (b[45] << 3))
