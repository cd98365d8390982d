"""Finite-field helpers: GF(2) polynomials and GF(2^m) tables.

Used to *derive* the standard code structures (BCH/Golay/RS generator
polynomials are mathematical constants of the protocols) rather than
hard-coding tables.  Everything is numpy int — exact integer semantics.

The port's own copy of ``dsdneo_tpu/fec/gf.py`` (numpy only).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# default primitive polynomials per extension degree (x^m + ... + 1)
PRIMITIVE_POLY = {
    4: 0b10011,        # x^4+x+1
    5: 0b100101,       # x^5+x^2+1
    6: 0b1000011,      # x^6+x+1   (P25 GF(64))
    8: 0b100011101,    # x^8+x^4+x^3+x^2+1 (CCSDS/DMR RS(12,9) uses 0x11D? see rs.py)
}


def poly_mul(a: int, b: int) -> int:
    """Multiply GF(2)[x] polynomials packed as ints (bit i = coeff of x^i)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        b >>= 1
    return r


def poly_mod(a: int, m: int) -> int:
    """Remainder of a(x) / m(x) in GF(2)[x]."""
    dm = m.bit_length() - 1
    da = a.bit_length() - 1
    while da >= dm:
        a ^= m << (da - dm)
        da = a.bit_length() - 1
    return a


def poly_divmod(a: int, m: int) -> tuple[int, int]:
    q = 0
    dm = m.bit_length() - 1
    da = a.bit_length() - 1
    while da >= dm:
        q |= 1 << (da - dm)
        a ^= m << (da - dm)
        da = a.bit_length() - 1
    return q, a


class GF2m:
    """GF(2^m) arithmetic with log/antilog tables (numpy-vectorizable)."""

    def __init__(self, m: int, prim_poly: int | None = None):
        self.m = m
        self.q = 1 << m
        self.prim_poly = prim_poly or PRIMITIVE_POLY[m]
        exp = np.zeros(2 * self.q, dtype=np.int32)
        log = np.zeros(self.q, dtype=np.int32)
        x = 1
        for i in range(self.q - 1):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & self.q:
                x ^= self.prim_poly
        exp[self.q - 1: 2 * self.q - 2] = exp[: self.q - 1]
        self.exp_table = exp
        self.log_table = log

    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int32)
        b = np.asarray(b, dtype=np.int32)
        out = np.zeros(np.broadcast(a, b).shape, dtype=np.int32)
        nz = (a != 0) & (b != 0)
        la = self.log_table[a * nz]
        lb = self.log_table[b * nz]
        out = np.where(nz, self.exp_table[(la + lb) % (self.q - 1)], 0)
        return out

    def inv(self, a):
        a = np.asarray(a, dtype=np.int32)
        return self.exp_table[(self.q - 1 - self.log_table[a]) % (self.q - 1)]

    def pow_alpha(self, i):
        return int(self.exp_table[i % (self.q - 1)])

    def poly_eval(self, coeffs: np.ndarray, x: int) -> int:
        """Evaluate polynomial (coeffs[0] = highest degree) at x (Horner)."""
        acc = 0
        for c in coeffs:
            acc = int(self.mul(acc, x)) ^ int(c)
        return acc

    @lru_cache(maxsize=None)
    def _min_poly(self, i: int) -> int:
        """Minimal polynomial over GF(2) of alpha^i, packed as int."""
        conj = set()
        j = i % (self.q - 1)
        while j not in conj:
            conj.add(j)
            j = (j * 2) % (self.q - 1)
        # poly = prod (x - alpha^j): coefficients in GF(2^m), result binary
        poly = [1]  # highest degree first
        for j in conj:
            root = self.pow_alpha(j)
            new = [0] * (len(poly) + 1)
            for k, c in enumerate(poly):
                new[k] ^= int(self.mul(c, 1))          # x * c
                new[k + 1] ^= int(self.mul(c, root))   # root * c
            poly = new
        packed = 0
        for k, c in enumerate(poly):
            assert c in (0, 1), "minimal polynomial not binary"
            packed |= c << (len(poly) - 1 - k)
        return packed


def bch_generator_poly(m: int, t_design_roots: int, prim_poly: int | None = None) -> int:
    """Generator polynomial of the narrow-sense binary BCH code of length
    2^m - 1 whose roots include alpha^1 .. alpha^t_design_roots.

    For P25's NID code (BCH(63,16,23)): m=6, roots alpha^1..alpha^22
    → degree-47 generator (reference parity:
    include/dsd-neo/fec/BCH_63_16.hpp).
    """
    f = GF2m(m, prim_poly)
    g = 1
    seen = set()
    for i in range(1, t_design_roots + 1):
        mp = f._min_poly(i)
        if mp not in seen:
            seen.add(mp)
            g = poly_mul(g, mp)
    return g


def systematic_codebook(g: int, n: int, k: int) -> np.ndarray:
    """All 2^k codewords of the systematic cyclic code with generator g.

    Returns uint8 array ``[2^k, n]``; codeword bit order: data bits first
    (message msb at index 0), then parity — c(x) = m(x)·x^(n-k) + rem.
    """
    nk = n - k
    # parity of each basis message bit
    basis = np.zeros((k, nk), dtype=np.uint8)
    for i in range(k):
        m_poly = 1 << (k - 1 - i)
        rem = poly_mod(m_poly << nk, g)
        basis[i] = [(rem >> (nk - 1 - j)) & 1 for j in range(nk)]
    msgs = ((np.arange(1 << k, dtype=np.uint32)[:, None]
             >> np.arange(k - 1, -1, -1, dtype=np.uint32)[None, :]) & 1).astype(np.uint8)
    parity = (msgs @ basis) & 1
    return np.concatenate([msgs, parity], axis=1).astype(np.uint8)
