"""Binary block codes as soft-decision maximum-likelihood codebook decoders.

Every short block code used by the LMR protocols
(BCH(63,16), Golay(24,12)/(20,8), Hamming family, QR(16,7,6)) has ≤ 2^16
codewords, so optimal decoding is a correlation against the full
codebook — one matrix product for a batch of received words, and
exact soft-decision ML (strictly stronger than the reference's
syndrome-table decoders in src/fec/fec.c and the algebraic decoders in
include/dsd-neo/fec/BCH_63_16.hpp / Golay24.hpp).

Codeword layouts are data-bits-first systematic, matching the protocol
standards' parity-check matrices H = [A | I] (TIA-102 / ETSI TS 102
361-1; the same tables appear in reference src/fec/fec.c:26-140).

The port's own copy of ``dsdneo_tpu/fec/blockcodes.py`` (numpy only),
the host decoders of the serial path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from dsdneo_tpu_torch.fec import gf


class MLBlockCode:
    """Soft/hard ML decoder over an explicit codebook."""

    def __init__(self, codebook: np.ndarray, n: int, k: int, name: str = ""):
        self.codebook = codebook.astype(np.uint8)        # [2^k, n]
        self.pm = (1.0 - 2.0 * self.codebook).astype(np.float32)  # ±1
        self.n = n
        self.k = k
        self.name = name

    def encode(self, msg: int) -> np.ndarray:
        return self.codebook[msg]

    def decode(self, bits: np.ndarray, reliab: np.ndarray | None = None
               ) -> tuple[int, int]:
        """Decode one received word.

        bits: ``[n]`` hard bits (0/1); reliab: optional ``[n]`` weights
        (higher = more trusted).  Returns (message, hard_error_count vs
        the chosen codeword).
        """
        r = 1.0 - 2.0 * bits.astype(np.float32)
        if reliab is not None:
            r = r * (reliab.astype(np.float32) + 1e-3)
        scores = self.pm @ r
        m = int(np.argmax(scores))
        errs = int(np.sum(self.codebook[m] != bits))
        return m, errs

    def decode_batch(self, bits: np.ndarray, reliab: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Decode ``[B, n]`` words → (messages ``[B]``, errors ``[B]``)."""
        r = 1.0 - 2.0 * bits.astype(np.float32)
        if reliab is not None:
            r = r * (reliab.astype(np.float32) + 1e-3)
        scores = r @ self.pm.T
        m = np.argmax(scores, axis=-1)
        errs = np.sum(self.codebook[m] != bits, axis=-1)
        return m.astype(np.int64), errs.astype(np.int64)


def _from_H(rows: tuple[str, ...], name: str) -> MLBlockCode:
    """Build the codebook of a systematic code from H = [A | I]."""
    n = len(rows[0])
    nk = len(rows)
    k = n - nk
    H = np.array([[int(ch) for ch in r] for r in rows], dtype=np.uint8)
    assert np.array_equal(H[:, k:], np.eye(nk, dtype=np.uint8)), name
    A = H[:, :k]
    msgs = ((np.arange(1 << k, dtype=np.uint32)[:, None]
             >> np.arange(k - 1, -1, -1, dtype=np.uint32)[None, :]) & 1).astype(np.uint8)
    parity = (msgs @ A.T) & 1
    cb = np.concatenate([msgs, parity], axis=1)
    return MLBlockCode(cb, n, k, name)


@lru_cache(maxsize=None)
def bch_63_16() -> MLBlockCode:
    """P25 NID code BCH(63,16,23): narrow-sense, roots α^1..α^22 over
    GF(64)/x^6+x+1.  Data = NAC(12) ‖ DUID(4), msb-first, followed by 47
    parity bits (reference parity: include/dsd-neo/fec/BCH_63_16.hpp and
    the NID read order in src/engine/dispatch/dispatch_p25p1.c:86-141)."""
    g = gf.bch_generator_poly(6, 22)
    assert g.bit_length() - 1 == 47, f"BCH(63,16) generator degree {g.bit_length() - 1}"
    cb = gf.systematic_codebook(g, 63, 16)
    return MLBlockCode(cb, 63, 16, "BCH(63,16,23)")


# Parity-check matrices H = [A | I] of the standard codes (TIA-102 /
# ETSI TS 102 361-1 annex B; identical tables in reference src/fec/fec.c).
_HAMMING_7_4_H = ("1110100", "0111010", "1101001")
_HAMMING_12_8_H = ("101011001000", "110101100100", "111010110010", "010110010001")
_HAMMING_13_9_H = ("1101011001000", "1110101100100", "1111010110010", "1010110010001")
_HAMMING_15_11_H = ("111101011001000", "011110101100100",
                    "001111010110010", "111010110010001")
_HAMMING_16_11_4_H = ("1111010110010000", "0111101011001000", "0011110101100100",
                      "1110101100100010", "1010011011100001")
_GOLAY_20_8_H = (
    "01001111100000000000", "01101000010000000000", "10110100001000000000",
    "11011010000100000000", "11101101000010000000", "10111001000001000000",
    "00010011000000100000", "11000110000000010000", "11100011000000001000",
    "00111110000000000100", "10011111000000000010", "01110101000000000001")
_GOLAY_24_12_H = (
    "101001001111100000000000", "111101101000010000000000",
    "011110110100001000000000", "001111011010000100000000",
    "000111101101000010000000", "101010111001000001000000",
    "111100010011000000100000", "110111000110000000010000",
    "011011100011000000001000", "100100111110000000000100",
    "010010011111000000000010", "110001110101000000000001")
_QR_16_7_6_H = (
    "0111100100000000", "0011110010000000", "1001111001000000",
    "0011011000100000", "0110001000010000", "1100100000001000",
    "1110010000000100", "1111001000000010", "1010111000000001")


@lru_cache(maxsize=None)
def golay_24_12() -> MLBlockCode:
    """Extended Golay(24,12,8) — DMR voice LC headers, P25 hexbits …"""
    return _from_H(_GOLAY_24_12_H, "Golay(24,12,8)")


@lru_cache(maxsize=None)
def golay_20_8() -> MLBlockCode:
    """Golay(20,8) — DMR EMB 7.1.4 / NXDN SACCH …"""
    return _from_H(_GOLAY_20_8_H, "Golay(20,8)")


@lru_cache(maxsize=None)
def hamming_7_4() -> MLBlockCode:
    return _from_H(_HAMMING_7_4_H, "Hamming(7,4)")


@lru_cache(maxsize=None)
def hamming_12_8() -> MLBlockCode:
    return _from_H(_HAMMING_12_8_H, "Hamming(12,8)")


@lru_cache(maxsize=None)
def hamming_13_9() -> MLBlockCode:
    return _from_H(_HAMMING_13_9_H, "Hamming(13,9)")


@lru_cache(maxsize=None)
def hamming_15_11() -> MLBlockCode:
    return _from_H(_HAMMING_15_11_H, "Hamming(15,11)")


@lru_cache(maxsize=None)
def hamming_16_11_4() -> MLBlockCode:
    return _from_H(_HAMMING_16_11_4_H, "Hamming(16,11,4)")


@lru_cache(maxsize=None)
def qr_16_7_6() -> MLBlockCode:
    return _from_H(_QR_16_7_6_H, "QR(16,7,6)")


@lru_cache(maxsize=None)
def hamming_10_6_3() -> MLBlockCode:
    """P25 Hamming(10,6,3) protecting RS hexbits in LDU link control
    (TIA-102.BAAA-A 7.4; generator G = [I6 | A] with A from the CAI)."""
    # parity columns of each data bit (4 parity bits, msb-first), from the
    # CAI parity equations p0=d0+d1+d2+d5, p1=d0+d1+d3+d5, p2=d0+d2+d3+d4,
    # p3=d1+d2+d3+d4 (same tables in reference src/fec/hamming_10_6_3.cpp).
    a_rows = ("1110", "1101", "1011", "0111", "0011", "1100")
    n, k = 10, 6
    A = np.array([[int(c) for c in r] for r in a_rows], dtype=np.uint8)  # [k, 4]
    msgs = ((np.arange(1 << k, dtype=np.uint32)[:, None]
             >> np.arange(k - 1, -1, -1, dtype=np.uint32)[None, :]) & 1).astype(np.uint8)
    parity = (msgs @ A) & 1
    cb = np.concatenate([msgs, parity], axis=1)
    return MLBlockCode(cb, n, k, "Hamming(10,6,3)")


@lru_cache(maxsize=None)
def golay_18_6_8() -> MLBlockCode:
    """P25 shortened Golay(18,6,8) protecting RS hexbits in the HDU
    (TIA-102.BAAA-A 7.3)."""
    full = golay_24_12().codebook
    mask = np.all(full[:, :6] == 0, axis=1)
    cb = full[mask][:, 6:]
    return MLBlockCode(cb, 18, 6, "Golay(18,6,8)")
