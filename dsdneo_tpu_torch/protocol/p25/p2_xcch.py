"""P25 Phase 2 host pieces of the voice path: the scrambler, the ISCH
lookup and hexbit packing.

The port's own copy of what ``dsdneo_tpu/engine/p2batch.py`` uses from
``dsdneo_tpu/protocol/p25/p2_xcch.py``: ``generate_scramble_bits``
(the WACN/SYS/NAC are pipeline arguments, so the LFSR runs here and is
not exported), ``ISCH_SYNC``, ``isch_lookup`` for words that miss the
ISCH table and ``_hexpack``.  The ISCH table itself (the 128 codewords
of the (40,9,16) code and their values) comes from
``data/tdma_tables.npz``.
"""

from __future__ import annotations

import numpy as np

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


def isch_lookup(word40: int, keys: np.ndarray, vals: np.ndarray,
                max_dist: int = 6) -> int:
    """40-bit ISCH → 7-bit value (chan_num<<5 | isch_loc<<3 | free<<2 |
    uf_count), or -1: the exact codeword, else the nearest within
    ``max_dist`` bits, the first of the table's order among equals.
    ``keys`` / ``vals`` are the table's codewords (sorted) and values."""
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
