"""Reed-Solomon codes on the host: the P25 Phase 2 ESS decode, the P25
Phase 1 hexword codes and DMR's full-LC RS(12,9).

The port's own copy of ``dsdneo_tpu/fec/rs.py`` (``ReedSolomon``,
``rs_63_35``, the shortened Phase 1 codes ``rs_24_12_13``,
``rs_24_16_9`` and ``rs_36_20_17`` over GF(64), and ``rs_12_9`` over
GF(256)): Berlekamp-Massey
with erasures folded in (the SACCH and FACCH decode passes the symbols
their layout does not transmit), a Chien search and Forney's formula,
in exact integers.  Symbol order: data
first, then parity; ``r[0]`` is the coefficient of the highest degree.
The field tables (GF(64): x^6 + x + 1, GF(256): x^8 + x^4 + x^3 + x^2 +
1) are ``fec.gf.GF2m``'s; K7's GF(64) tables (``gf64_tables``) come from
``data/tdma_tables.npz`` and equal them.  The
voice path decodes on the host only the words whose syndromes, screened
on the card by ``fec.device.rs_syndromes_batch`` (kernel K7), are not
all zero.
"""

from __future__ import annotations

import functools

import numpy as np

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.fec.gf import GF2m


@functools.lru_cache(maxsize=1)
def gf64_tables() -> tuple[np.ndarray, np.ndarray]:
    """GF(64) (exp ``[128]``, log ``[64]``) int32: exp[i] = α^i, with
    the first 63 entries repeated so a sum of two logs needs no
    reduction."""
    with np.load(params.TDMA_TABLES_NPZ) as z:
        return z["gf64_exp"].astype(np.int32), z["gf64_log"].astype(np.int32)


class ReedSolomon:
    """RS(n, k) over GF(2^m) (GF(64) by default) with first consecutive
    root α^fcr."""

    def __init__(self, n: int, k: int, fcr: int = 1, m: int = 6,
                 prim_poly: int | None = None):
        f = GF2m(m, prim_poly)
        self.exp, self.log = f.exp_table.tolist(), f.log_table.tolist()
        self.q1 = (1 << m) - 1
        self.n, self.k, self.nroots, self.fcr = n, k, n - k, fcr
        # generator g(x) = prod (x - α^(fcr+i)), lowest degree first
        g = [1]
        for i in range(self.nroots):
            root = self.exp[(fcr + i) % self.q1]
            ng = [0] * (len(g) + 1)
            for j, c in enumerate(g):
                ng[j + 1] ^= c
                ng[j] ^= self._mul(c, root)
            g = ng
        self.genpoly = g

    def _mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return self.exp[(self.log[a] + self.log[b]) % self.q1]

    def _pow(self, base_log: int, e: int) -> int:
        return self.exp[(base_log * e) % self.q1]

    def _inv(self, a: int) -> int:
        return self.exp[(self.q1 - self.log[a]) % self.q1]

    def encode(self, data) -> np.ndarray:
        """``[k]`` data symbols → the ``[n]`` codeword (data ‖ parity)."""
        msg = np.asarray(data, dtype=np.int32)
        rem = [0] * self.nroots
        gp_hi = self.genpoly[::-1]
        for d in msg.tolist():
            feedback = d ^ rem[0]
            rem = rem[1:] + [0]
            if feedback:
                for j in range(self.nroots):
                    rem[j] ^= self._mul(gp_hi[j + 1], feedback)
        return np.concatenate([msg, np.asarray(rem, dtype=np.int32)])

    def syndromes(self, r) -> list[int]:
        out = []
        for i in range(self.nroots):
            x = self.exp[(self.fcr + i) % self.q1]
            acc = 0
            for c in r:
                acc = self._mul(acc, x) ^ int(c)
            out.append(acc)
        return out

    def decode(self, word, erasures=None) -> tuple[np.ndarray, int]:
        """``[n]`` received symbols → (corrected word, symbols corrected),
        the count -1 when the word cannot be decoded.  ``erasures``: the
        positions known to be unreliable (at most ``nroots`` are used)."""
        r = np.asarray(word, dtype=np.int32).copy()
        n, nroots, q1 = self.n, self.nroots, self.q1
        S = self.syndromes(r)
        if not any(S):
            return r, 0
        # the erasure locator prod (1 - X_j z), lowest degree first
        lam = [1] + [0] * nroots
        n_eras = 0
        for pos in sorted(set(erasures or ())):
            if n_eras >= nroots or pos >= n:
                continue
            x = self.exp[(n - 1 - pos) % q1]
            for j in range(nroots, 0, -1):
                lam[j] ^= self._mul(lam[j - 1], x)
            n_eras += 1
        # Berlekamp-Massey from the erasure locator: the errata locator
        B = lam.copy()
        L = n_eras
        for i in range(n_eras, nroots):
            delta = 0
            for j in range(L + 1):
                delta ^= self._mul(lam[j], S[i - j])
            B = [0] + B[:-1]
            if delta != 0:
                T = [lam[j] ^ self._mul(B[j], delta)
                     for j in range(nroots + 1)]
                if 2 * L <= i + n_eras:
                    inv_d = self._inv(delta)
                    B = [self._mul(c, inv_d) for c in lam]
                    L = i + 1 + n_eras - L
                lam = T
        deg = max((j for j in range(nroots + 1) if lam[j]), default=0)
        if deg == 0:
            return r, -1
        # Chien search: the roots at X_j^-1
        err_pos = []
        for pos in range(n):
            xinv = (q1 - (n - 1 - pos) % q1) % q1
            acc = 0
            for j in range(deg + 1):
                if lam[j]:
                    acc ^= self._mul(lam[j], self._pow(xinv, j))
            if acc == 0:
                err_pos.append(pos)
        if len(err_pos) != deg:
            return r, -1
        # Forney: Omega(z) = S(z) Lam(z) mod z^nroots
        omega = [0] * nroots
        for i in range(nroots):
            acc = 0
            for j in range(min(i, deg) + 1):
                acc ^= self._mul(lam[j], S[i - j])
            omega[i] = acc
        for pos in err_pos:
            xlog = (n - 1 - pos) % q1
            xinv = (q1 - xlog) % q1
            num = 0
            for i in range(nroots):
                if omega[i]:
                    num ^= self._mul(omega[i], self._pow(xinv, i))
            den = 0
            for j in range(1, deg + 1, 2):
                if lam[j]:
                    den ^= self._mul(lam[j], self._pow(xinv, j - 1))
            if den == 0:
                return r, -1
            mag = self._mul(num, self._inv(den))
            if self.fcr != 1:
                mag = self._mul(mag, self._pow(xlog, (1 - self.fcr) % q1))
            r[pos] ^= mag
        if any(self.syndromes(r)):
            return r, -1
        return r, len(err_pos)


@functools.lru_cache(maxsize=None)
def rs_63_35() -> ReedSolomon:
    """P25 Phase 2 RS(63,35,29): SACCH, FACCH and the ESS."""
    return ReedSolomon(63, 35, fcr=1)


@functools.lru_cache(maxsize=None)
def rs_24_12_13() -> ReedSolomon:
    """P25 RS(24,12,13): LDU1 and TDULC link control (shortened)."""
    return ReedSolomon(24, 12, fcr=1)


@functools.lru_cache(maxsize=None)
def rs_24_16_9() -> ReedSolomon:
    """P25 RS(24,16,9): the LDU2 encryption sync (shortened)."""
    return ReedSolomon(24, 16, fcr=1)


@functools.lru_cache(maxsize=None)
def rs_36_20_17() -> ReedSolomon:
    """P25 RS(36,20,17): the HDU (shortened)."""
    return ReedSolomon(36, 20, fcr=1)


@functools.lru_cache(maxsize=None)
def rs_12_9() -> ReedSolomon:
    """DMR RS(12,9,4) over GF(256): the full LC of the voice LC header
    and the terminator (ETSI TS 102 361-1 B.3.6)."""
    return ReedSolomon(12, 9, fcr=0, m=8, prim_poly=0b100011101)
