"""DMR rate-3/4 trellis code (ETSI TS 102 361-1 B.2.2).

98 payload dibits carry 49 constellation points over an 8-state, 49-step
trellis whose state sequence IS the data (48 tribits = 18 bytes, plus a
flush step).  Hard-decision Viterbi with point-Hamming branch metrics.
Reference parity: src/fec/trellis34.c tables,
src/protocol/dmr/dmr_34_viterbi.c decode flow.

The port's own copy of ``dsdneo_tpu/fec/trellis34.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

import numpy as np

# dibit-level interleave: deinterleaved[INTERLEAVE[i]] = received[i]
INTERLEAVE_98 = np.array([
    0, 1, 8, 9, 16, 17, 24, 25, 32, 33, 40, 41, 48, 49, 56, 57, 64, 65,
    72, 73, 80, 81, 88, 89, 96, 97, 2, 3, 10, 11, 18, 19, 26, 27, 34, 35,
    42, 43, 50, 51, 58, 59, 66, 67, 74, 75, 82, 83, 90, 91, 4, 5, 12, 13,
    20, 21, 28, 29, 36, 37, 44, 45, 52, 53, 60, 61, 68, 69, 76, 77, 84,
    85, 92, 93, 6, 7, 14, 15, 22, 23, 30, 31, 38, 39, 46, 47, 54, 55, 62,
    63, 70, 71, 78, 79, 86, 87, 94, 95], dtype=np.int64)

# nibble (dibit pair) → constellation point
CONSTELLATION = np.array([11, 12, 0, 7, 14, 9, 5, 2, 10, 13, 1, 6, 15, 8,
                          4, 3], dtype=np.uint8)

# FSM[prev_state, next_state] → expected constellation point
FSM = np.array([
    [0, 8, 4, 12, 2, 10, 6, 14], [4, 12, 2, 10, 6, 14, 0, 8],
    [1, 9, 5, 13, 3, 11, 7, 15], [5, 13, 3, 11, 7, 15, 1, 9],
    [3, 11, 7, 15, 1, 9, 5, 13], [7, 15, 1, 9, 5, 13, 3, 11],
    [2, 10, 6, 14, 0, 8, 4, 12], [6, 14, 0, 8, 4, 12, 2, 10]],
    dtype=np.uint8)

_POPCNT = np.array([bin(i).count("1") for i in range(16)], dtype=np.int64)
_T, _S = 49, 8


def _points_from_dibits(dibits98: np.ndarray) -> np.ndarray:
    dei = np.zeros(98, dtype=np.uint8)
    dei[INTERLEAVE_98] = dibits98 & 3
    nibs = (dei[0::2] << 2) | dei[1::2]
    return CONSTELLATION[nibs]


def decode_r34(dibits98: np.ndarray) -> tuple[np.ndarray, int]:
    """98 dibits → (18 data bytes, path metric in point-bit errors)."""
    obs = _points_from_dibits(np.asarray(dibits98, dtype=np.uint8))
    # branch cost [t, prev, next] via vectorized popcount
    cost = _POPCNT[(FSM[None, :, :] ^ obs[:, None, None]) & 0xF]
    inf = 1 << 30
    metric = np.full(_S, inf, dtype=np.int64)
    metric[0] = 0
    backptr = np.zeros((_T, _S), dtype=np.int64)
    for t in range(_T):
        tot = metric[:, None] + cost[t]          # [prev, next]
        backptr[t] = np.argmin(tot, axis=0)
        metric = tot[backptr[t], np.arange(_S)]
    end = int(np.argmin(metric))
    states = np.zeros(_T, dtype=np.uint8)
    s = end
    for t in range(_T - 1, -1, -1):
        states[t] = s
        s = backptr[t, s]
    out = np.zeros(18, dtype=np.uint8)
    for g in range(6):
        v = 0
        for k in range(8):
            v = (v << 3) | int(states[g * 8 + k] & 7)
        out[g * 3] = (v >> 16) & 0xFF
        out[g * 3 + 1] = (v >> 8) & 0xFF
        out[g * 3 + 2] = v & 0xFF
    return out, int(metric[end])


def encode_r34(data18: np.ndarray) -> np.ndarray:
    """18 data bytes → 98 on-air dibits (for loopback tests)."""
    data18 = np.asarray(data18, dtype=np.uint8)
    bits = np.unpackbits(data18)
    tribits = [(int(bits[3 * i]) << 2) | (int(bits[3 * i + 1]) << 1)
               | int(bits[3 * i + 2]) for i in range(48)]
    states = tribits + [0]                      # flush step
    inv = np.zeros(16, dtype=np.uint8)
    inv[CONSTELLATION] = np.arange(16, dtype=np.uint8)
    prev = 0
    nibs = np.zeros(_T, dtype=np.uint8)
    for t, s in enumerate(states):
        nibs[t] = inv[FSM[prev, s]]
        prev = s
    dei = np.zeros(98, dtype=np.uint8)
    dei[0::2] = nibs >> 2
    dei[1::2] = nibs & 3
    return dei[INTERLEAVE_98]
