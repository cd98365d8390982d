"""IMBE-7100x4400 ECC layer (EDACS ProVoice) — hypothesis + grader.

The 7100 bps IMBE variant (reference consumes it via mbelib-neo's
mbe_processImbe7100x4400Framef; src/protocol/provoice/provoice.c only
deinterleaves) carries 142 bits per 20 ms frame in the [7, 24]
code-vector layout the deinterleaver recovers.  The PN/seed-inversion
methodology that recovered the IMBE-7200 and AMBE+2 conventions
(PARITY.md round-1 notes) needs off-air frames to grade hypotheses —
and NO ProVoice voice material is available to this project (the
reference test suite ships none either; its edacs.iq fixture is
control-channel only).  What this module therefore provides:

1. the structural ECC hypothesis consistent with the frame geometry
   and the 7200 conventions — u0..u3 Golay(23,12) (u1..u3 PN-scrambled
   from the u0 parameter seed, exactly the 7200 PN recurrence), u4..u5
   Hamming(15,11) PN-scrambled, u6 raw tail — with encode/decode kept
   roundtrip-exact so the convention is testable end to end;
2. ``grade_hypotheses``: the automated seed-inversion grader — feed it
   real off-air [N, 7, 24] frames and it ranks every convention combo
   (PN on/off per block class, seed source, bit order) by mean Golay
   syndrome error; ~0 errors identifies the on-air convention the
   moment real material is available.

Status: UNVERIFIED against off-air data (negative result recorded in
PARITY.md round-3 notes) — the decoder surfaces per-frame ECC error
counts and marks the hypothesis accordingly.

The port's own copy of ``dsdneo_tpu/protocol/provoice/imbe7100.py``
(numpy only); it is held to the JAX package, not to off-air data.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from dsdneo_tpu_torch.protocol.p25.imbe_frame import _pn_bits, golay_23_12


@lru_cache(maxsize=1)
def _tables():
    g23 = golay_23_12()
    from dsdneo_tpu_torch.fec import blockcodes
    h15 = blockcodes.hamming_15_11()
    return g23, h15


@lru_cache(maxsize=1)
def carried_positions() -> tuple:
    """The 142 [7, 24] cells the air interface actually carries, in
    row-major order — derived from the reference's interleave tables
    (provoice_const.h w/x schedules via encode.pair_bit_schedule).
    Row extents are 19/24/23/23/15/15/23: NOT row-aligned with the
    codeword lengths, so the ECC hypothesis lays its codewords over
    this flat order."""
    from dsdneo_tpu_torch.protocol.provoice.encode import pair_bit_schedule
    cells = sorted({(w, x) for tag, w, x in pair_bit_schedule()
                    if tag == "1"})
    assert len(cells) == 142
    return tuple(cells)


def _flat(fr: np.ndarray) -> np.ndarray:
    cells = carried_positions()
    return fr[tuple(np.array(cells).T)]


def _unflat(bits142: np.ndarray) -> np.ndarray:
    fr = np.zeros((7, 24), dtype=np.uint8)
    for (w, x), b in zip(carried_positions(), bits142):
        fr[w, x] = b
    return fr


def decode_imbe7100_ecc(fr: np.ndarray, pn: bool = True
                        ) -> tuple[np.ndarray, int]:
    """[7, 24] code vectors → (90 parameter bits [u0..u5 data ‖ tail],
    total corrected-bit count).

    Hypothesis layout (see module docstring) over the 142 CARRIED bits
    in flat row-major order: u0 Golay(23,12) clear; u1..u3 Golay(23,12)
    XOR PN; u4..u5 Hamming(15,11) XOR PN; 20 raw tail bits.  PN seed =
    u0's 12 parity bits (LSB-first, the 7200 convention)."""
    g23, h15 = _tables()
    flat = _flat(np.asarray(fr, dtype=np.uint8))
    m0, e0 = g23.decode(flat[0:23])
    errs = int(e0)
    out = np.zeros(90, dtype=np.uint8)
    for i in range(12):
        out[i] = (m0 >> (11 - i)) & 1
    seed = 0
    cw0 = g23.codebook[m0]
    for k in range(12):
        seed |= int(cw0[11 + k]) << k
    pnb = _pn_bits(seed & 0xFFF, 114) if pn else np.zeros(114, np.uint8)
    pos = 0
    fpos = 23
    k = 12
    for _ in range(3):
        w = flat[fpos:fpos + 23] ^ (pnb[pos:pos + 23][::-1] if pn else 0)
        fpos += 23
        pos += 23
        m, e = g23.decode(w)
        errs += int(e)
        for i in range(12):
            out[k + i] = (m >> (11 - i)) & 1
        k += 12
    for _ in range(2):
        w = flat[fpos:fpos + 15] ^ (pnb[pos:pos + 15][::-1] if pn else 0)
        fpos += 15
        pos += 15
        m, e = h15.decode(w)
        errs += int(e)
        for i in range(11):
            out[k + i] = (m >> (10 - i)) & 1
        k += 11
    out[k:k + 20] = flat[fpos:fpos + 20]
    return out, errs


def encode_imbe7100_ecc(bits90: np.ndarray, pn: bool = True) -> np.ndarray:
    """Inverse of decode_imbe7100_ecc (roundtrip tests / synthesis)."""
    g23, h15 = _tables()
    b = np.asarray(bits90, dtype=np.uint8)
    flat = np.zeros(142, dtype=np.uint8)
    m0 = 0
    for i in range(12):
        m0 = (m0 << 1) | int(b[i])
    cw0 = g23.codebook[m0]
    flat[0:23] = cw0
    seed = 0
    for k in range(12):
        seed |= int(cw0[11 + k]) << k
    pnb = _pn_bits(seed & 0xFFF, 114) if pn else np.zeros(114, np.uint8)
    pos = 0
    fpos = 23
    k = 12
    for _ in range(3):
        m = 0
        for i in range(12):
            m = (m << 1) | int(b[k + i])
        k += 12
        flat[fpos:fpos + 23] = g23.codebook[m] ^ (pnb[pos:pos + 23][::-1]
                                                  if pn else 0)
        fpos += 23
        pos += 23
    for _ in range(2):
        m = 0
        for i in range(11):
            m = (m << 1) | int(b[k + i])
        k += 11
        flat[fpos:fpos + 15] = h15.codebook[m] ^ (pnb[pos:pos + 15][::-1]
                                                  if pn else 0)
        fpos += 15
        pos += 15
    flat[fpos:fpos + 20] = b[k:k + 20]
    return _unflat(flat)


def grade_hypotheses(frames: np.ndarray) -> list[dict]:
    """Seed-inversion grader over real off-air [N, 7, 24] frames:
    ranks convention combos by mean Golay(23,12) corrected-bit count on
    rows u1..u3 (u0 is convention-independent).  A true convention
    grades near the channel BER (≈0 on clean signal); wrong ones grade
    at the random-codeword floor (≈3.7/23 per row).

    Combos: PN on/off, seed field (u0 parity bits LSB-first / MSB-first
    / u0 data bits), PN row bit order (reversed / forward)."""
    g23, _ = _tables()
    frames = np.asarray(frames, dtype=np.uint8)
    results = []
    for pn_on in (True, False):
        for seed_src in ("parity_lsb", "parity_msb", "data"):
            for rev in (True, False):
                if not pn_on and (seed_src != "parity_lsb" or not rev):
                    continue
                tot = 0
                cnt = 0
                for fr in frames:
                    flat = _flat(fr)
                    m0, _e = g23.decode(flat[0:23])
                    cw0 = g23.codebook[m0]
                    seed = 0
                    if seed_src == "parity_lsb":
                        for k in range(12):
                            seed |= int(cw0[11 + k]) << k
                    elif seed_src == "parity_msb":
                        for k in range(12):
                            seed = (seed << 1) | int(cw0[11 + k])
                    else:
                        seed = m0
                    pnb = _pn_bits(seed & 0xFFF, 114) if pn_on \
                        else np.zeros(114, np.uint8)
                    pos = 0
                    fpos = 23
                    for _row in range(3):
                        blk = pnb[pos:pos + 23]
                        pos += 23
                        w = flat[fpos:fpos + 23] ^ (blk[::-1] if rev
                                                    else blk)
                        fpos += 23
                        _m, e = g23.decode(w)
                        tot += int(e)
                        cnt += 1
                results.append({"pn": pn_on, "seed": seed_src,
                                "reversed": rev,
                                "mean_errs": tot / max(cnt, 1)})
    results.sort(key=lambda r: r["mean_errs"])
    return results
