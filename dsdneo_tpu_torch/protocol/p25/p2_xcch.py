"""P25 Phase 2 host pieces: the scrambler, the ISCH, hexbit packing and
the SACCH/FACCH channel coding.

The port's own copy of ``dsdneo_tpu/protocol/p25/p2_xcch.py``
(reference src/protocol/p25/phase2/p25p2_scramble.c, the 44-bit
Fibonacci LFSR; src/fec/ez.cpp, the ISCH (40,9,16) code and the
RS(63,35) hexbit packing; src/protocol/p25/phase2/p25p2_frame.c, the bit
geometry and the fixed erasures; p25_crc.c, CRC12):
``generate_scramble_bits`` (the WACN/SYS/NAC are pipeline arguments, so
the LFSR runs here and is not exported), the ISCH codewords and
``isch_lookup`` for words that miss the ISCH table (the table itself,
the 128 codewords and their values, comes from
``data/tdma_tables.npz``), ``_hexpack``, CRC12 and its GF(2)
contribution table, the RS(63,35) encode and erasure decode of the xCCH
layouts with the GF(2) map of the systematic encode, the timeslot bit
geometry, and the blind recovery of the scramble seed.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from dsdneo_tpu_torch.fec.rs import rs_63_35

# the ISCH code is affine over GF(2): codeword = C0 ^ the G[i] of the
# set bits of the 7-bit value
_ISCH_C0 = 0x184229D461
_ISCH_G = (0x343D8597, 0x58CBAA4E, 0x9DA3A171, 0x9048D9B72,
           0x20807F7FF, 0xC00DED18E, 0x100F4B1758)

ISCH_SYNC = 0x575D57F7FF      # unscrambled sync variant (skipped)


def generate_scramble_bits(wacn: int, sysid: int, nac: int,
                           n: int) -> np.ndarray:
    """TIA-102.BBAC Fig 7.1 external 44-bit Fibonacci LFSR:
    x^44 + x^34 + x^20 + x^15 + x^9 + x^4 + 1, seeded
    WACN<<24|SYS<<12|NAC → ``n`` uint8 bits."""
    seed = ((wacn & 0xFFFFF) << 24) | ((sysid & 0xFFF) << 12) | (nac & 0xFFF)
    out = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        out[i] = (seed >> 43) & 1
        bit = ((seed >> 33) ^ (seed >> 19) ^ (seed >> 14) ^ (seed >> 8)
               ^ (seed >> 3) ^ (seed >> 43)) & 1
        seed = ((seed << 1) | bit) & 0xFFFFFFFFFFF
    return out


def isch_codeword(value: int) -> int:
    """7-bit ISCH value → its 40-bit codeword."""
    w = _ISCH_C0
    for i in range(7):
        if (value >> i) & 1:
            w ^= _ISCH_G[i]
    return w


@lru_cache(maxsize=1)
def isch_table() -> tuple[np.ndarray, np.ndarray]:
    """The 128 ISCH codewords (sorted) and their 7-bit values."""
    cw = np.array([isch_codeword(v) for v in range(128)], dtype=np.int64)
    order = np.argsort(cw)
    return cw[order], np.arange(128, dtype=np.int64)[order]


def isch_lookup(word40: int, keys: np.ndarray | None = None,
                vals: np.ndarray | None = None, max_dist: int = 6) -> int:
    """40-bit ISCH → 7-bit value (chan_num<<5 | isch_loc<<3 | free<<2 |
    uf_count), or -1: the exact codeword, else the nearest within
    ``max_dist`` bits, the first of the table's order among equals.
    ``keys`` / ``vals`` are the table's codewords (sorted) and values
    (by default :func:`isch_table`)."""
    if keys is None:
        keys, vals = isch_table()
    j = int(np.searchsorted(keys, word40))
    if j < len(keys) and int(keys[j]) == word40:
        return int(vals[j])
    # the nearest codeword, the first in order of value among equals
    # (the JAX package's table is a dict built for values 0..127)
    order = np.argsort(vals, kind="stable")
    best, best_d = -1, max_dist + 1
    for cw, v in zip(keys[order].tolist(), vals[order].tolist()):
        d = bin(cw ^ word40).count("1")
        if d < best_d:
            best, best_d = v, d
    return best


def _hexpack(bits: np.ndarray) -> np.ndarray:
    """Bits, msb first → 6-bit symbols (int64)."""
    b = np.asarray(bits, dtype=np.int64)
    n = len(b) // 6
    return b[:6 * n].reshape(n, 6) @ (1 << np.arange(5, -1, -1))


# -- CRC12 ----------------------------------------------------------------

_CRC12_POLY = 0b1100010010111   # x^12+x^11+x^7+x^4+x^2+x+1


def _crc12_raw(bits: np.ndarray, n: int) -> int:
    """CRC12 remainder over bits[0:n] WITHOUT the final inversion."""
    buf = np.concatenate([bits[:n].astype(np.uint8), np.zeros(12, np.uint8)])
    poly = [(_CRC12_POLY >> (12 - i)) & 1 for i in range(13)]
    for i in range(n):
        if buf[i]:
            for j in range(13):
                buf[i + j] ^= poly[j]
    crc = 0
    for i in range(12):
        crc = (crc << 1) | int(buf[n + i])
    return crc


def crc12_of(bits: np.ndarray, n: int) -> int:
    """CRC12 over bits[0:n] with the 0xFFF final inversion (the value
    transmitted at bits[n:n+12]) — the TX side of :func:`crc12_ok`."""
    return _crc12_raw(bits, n) ^ 0xFFF


def crc12_ok(bits: np.ndarray, n: int) -> bool:
    """CRC12 over bits[0:n], received at bits[n:n+12] (reference
    p25_crc.c crc12, final inversion 0xFFF)."""
    crc = _crc12_raw(bits, n) ^ 0xFFF
    rx = 0
    for i in range(12):
        rx = (rx << 1) | int(bits[n + i])
    return crc == rx


@lru_cache(maxsize=None)
def crc12_matrix(n: int) -> np.ndarray:
    """[n, 12] GF(2) contribution table: crc12(bits[:n]) (no inversion)
    = XOR of the rows at set bit positions — CRC is linear, so a fleet
    of payloads screens in one ``(payloads @ M) % 2`` matmul."""
    tab = np.zeros((n, 12), dtype=np.uint8)
    e = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        e[:] = 0
        e[i] = 1
        v = _crc12_raw(e, n)
        tab[i] = [(v >> (11 - j)) & 1 for j in range(12)]
    return tab


# -- SACCH / FACCH RS(63,35) ----------------------------------------------

# hexbit layout inside the 63-symbol RS codeword (reference ez.cpp):
#   SACCH: payload at 5..34 (30 hexbits), parity at 35..56; 0-4, 57-62
#   untransmitted (fixed erasures).  FACCH: payload at 9..34 (26),
#   parity at 35..53; 0-8, 54-62 erased.
_LAYOUT = {
    "sacch": (5, 30, 22, [0, 1, 2, 3, 4, 57, 58, 59, 60, 61, 62]),
    "facch": (9, 26, 19, [0, 1, 2, 3, 4, 5, 6, 7, 8, 54, 55, 56, 57,
                          58, 59, 60, 61, 62]),
}


def xcch_rs_decode(payload_bits: np.ndarray, parity_bits: np.ndarray,
                   kind: str) -> tuple[np.ndarray, int]:
    """RS(63,35) correction → (corrected payload bits, n_corrected|-1)."""
    j0, np_hex, npar_hex, erasures = _LAYOUT[kind]
    vec = np.zeros(63, dtype=np.int64)
    vec[j0:j0 + np_hex] = _hexpack(payload_bits[:np_hex * 6])
    vec[35:35 + npar_hex] = _hexpack(parity_bits[:npar_hex * 6])
    dec, nerr = rs_63_35().decode(vec, erasures=erasures)
    out = payload_bits.copy()
    if nerr >= 0:
        for i in range(np_hex):
            for j in range(6):
                out[6 * i + j] = (int(dec[j0 + i]) >> (5 - j)) & 1
    return out, nerr


@lru_cache(maxsize=None)
def xcch_encode_matrix(kind: str) -> np.ndarray:
    """[n_payload_bits, n_parity_bits] GF(2) map of the SYSTEMATIC
    RS(63,35) encode over the transmitted layout: a received burst is
    error-free iff ``(payload @ M) % 2 == parity`` — RS encoding over
    GF(2^6) is GF(2)-linear, so the whole fleet's xCCH bursts screen in
    one matmul and only the failures fall back to the Berlekamp–Massey
    erasure decode (the batched-control-pipeline philosophy of
    engine.ccbatch, here for the TDMA control channel)."""
    j0, np_hex, npar_hex, _ = _LAYOUT[kind]
    n = np_hex * 6
    M = np.zeros((n, npar_hex * 6), dtype=np.uint8)
    e = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        e[:] = 0
        e[i] = 1
        M[i] = xcch_rs_encode(e, kind)
    return M


def xcch_rs_encode(payload_bits: np.ndarray, kind: str) -> np.ndarray:
    """Systematic RS(63,35) parity bits for loopback tests."""
    j0, np_hex, npar_hex, _ = _LAYOUT[kind]
    vec = np.zeros(35, dtype=np.int64)
    vec[j0:j0 + np_hex] = _hexpack(payload_bits[:np_hex * 6])
    full = rs_63_35().encode(vec)
    parity = np.zeros(npar_hex * 6, dtype=np.uint8)
    for i in range(npar_hex):
        for j in range(6):
            parity[6 * i + j] = (int(full[35 + i]) >> (5 - j)) & 1
    return parity


# timeslot bit geometry (360 bits per timeslot; reference p25p2_frame.c
# process_SACCHs/process_FACCHs)
def extract_sacch(ts_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    payload = np.concatenate([ts_bits[2:74], ts_bits[76:184]])
    parity = np.concatenate([ts_bits[184:244], ts_bits[246:318]])
    return payload, parity


def extract_facch(ts_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    payload = np.concatenate([ts_bits[2:74], ts_bits[76:138],
                              ts_bits[180:202]])
    parity = np.concatenate([ts_bits[202:244], ts_bits[246:318]])
    return payload, parity


def insert_sacch(ts_bits: np.ndarray, payload: np.ndarray,
                 parity: np.ndarray) -> None:
    ts_bits[2:74] = payload[0:72]
    ts_bits[76:184] = payload[72:180]
    ts_bits[184:244] = parity[0:60]
    ts_bits[246:318] = parity[60:132]


def insert_facch(ts_bits: np.ndarray, payload: np.ndarray,
                 parity: np.ndarray) -> None:
    ts_bits[2:74] = payload[0:72]
    ts_bits[76:138] = payload[72:134]
    ts_bits[180:202] = payload[134:156]
    ts_bits[202:244] = parity[0:42]
    ts_bits[246:318] = parity[42:114]


# -- blind scramble-parameter recovery --------------------------------------
#
# The scrambler keystream is LINEAR over GF(2) in the 44 seed bits
# (pure Fibonacci LFSR, no additive constant), and so is the RS(63,35)
# systematic parity map.  For a scrambled xCCH burst c at superframe
# position p, the descrambled timeslot x = c ^ ks(seed)[base:base+360]
# must satisfy the RS parity equations, so
#
#     F(c) ^ M_p . seed = 0     with F(t) = rs_encode(payload(t)) ^ parity(t)
#
# — 132 (SACCH) / 114 (FACCH) GF(2)-linear equations in 44 unknowns from
# ONE error-free burst.  Solving recovers the network's WACN/SYS/NAC
# straight off the air, without waiting for an unscrambled network
# status broadcast (the reference can only learn the identity from
# NET_STS / -X, src/protocol/p25/phase2/p25p2_vpdu.c).  Bursts carrying
# channel errors make the overdetermined system inconsistent and are
# simply skipped; a candidate seed is accepted only when the other
# collected bursts RS-decode under it.

def _parity_residual(ts_bits: np.ndarray, kind: str) -> np.ndarray:
    ex = extract_sacch if kind == "sacch" else extract_facch
    payload, parity = ex(ts_bits)
    return xcch_rs_encode(payload, kind) ^ parity


@lru_cache(maxsize=1)
def _seed_keystreams() -> np.ndarray:
    """[44, 4340] keystreams of the unit seeds (bit 43-k set)."""
    out = np.zeros((44, 4340), dtype=np.uint8)
    for k in range(44):
        bit = 1 << (43 - k)
        out[k] = generate_scramble_bits(bit >> 24, (bit >> 12) & 0xFFF,
                                        bit & 0xFFF, 4340)
    return out


@lru_cache(maxsize=24)
def _seed_matrix(p: int, kind: str) -> np.ndarray:
    """Residual of each unit-seed keystream slice at position p."""
    base = 360 * p + 20
    ks = _seed_keystreams()
    return np.stack([_parity_residual(ks[k, base:base + 360], kind)
                     for k in range(44)], axis=1)   # [R, 44]


def _solve_gf2(M: np.ndarray, rhs: np.ndarray) -> int | None:
    """Full-rank consistent GF(2) solve or None."""
    A = np.concatenate([M, rhs[:, None]], axis=1).astype(np.uint8)
    rows, _ = A.shape
    piv = []
    r = 0
    for c in range(44):
        nz = np.nonzero(A[r:, c])[0]
        if nz.size == 0:
            continue
        A[[r, r + nz[0]]] = A[[r + nz[0], r]]
        mask = A[:, c].copy()
        mask[r] = 0
        A[mask.astype(bool)] ^= A[r]
        piv.append(c)
        r += 1
        if r == rows:
            break
    if len(piv) < 44 or np.any(A[r:, 44]):
        return None
    seed = 0
    for i, c in enumerate(piv):
        # pivots are found in increasing column order, so c == i here,
        # but index defensively
        seed |= int(A[i, 44]) << (43 - c)
    return seed


def recover_scramble_seed(bursts) -> tuple[int, int, int] | None:
    """Blind WACN/SYS/NAC recovery from scrambled xCCH bursts.

    ``bursts``: iterable of (ts_bits[360], superframe_pos 0-11, kind)
    with kind "sacch"|"facch".  Returns (wacn, sysid, nac) when one
    burst yields a full-rank consistent solution that RS-validates on
    the other bursts, else None.
    """
    items = list(bursts)
    for ts_bits, p, kind in items:
        M = _seed_matrix(int(p), kind)
        seed = _solve_gf2(M, _parity_residual(ts_bits, kind))
        if seed is None:
            continue
        wacn, sysid, nac = seed >> 24, (seed >> 12) & 0xFFF, seed & 0xFFF
        others = [b for b in items if b[0] is not ts_bits]
        if others:
            ks = generate_scramble_bits(wacn, sysid, nac, 4340)
            npass = 0
            for tb, p2, kind2 in others:
                base = 360 * int(p2) + 20
                x = tb ^ ks[base:base + 360]
                ex = extract_sacch if kind2 == "sacch" else extract_facch
                pl, pr = ex(x)
                _, nerr = xcch_rs_decode(pl, pr, kind2)
                npass += (nerr >= 0)
            if npass < max(1, len(others) // 2):
                continue              # lucky solve on a corrupt burst
        return int(wacn), int(sysid), int(nac)
    return None
