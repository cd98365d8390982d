"""Rate-1/2 K=5 convolutional code (G1 = 1+D³+D⁴, G2 = 1+D+D²+D⁴).

Shared by NXDN (SACCH/FACCH/CAC; reference
src/protocol/nxdn/nxdn_convolution.c) and M17 (same generators;
reference src/protocol/m17/m17_algorithms.c).

Soft-decision Viterbi over {0,1} symbols with per-symbol weights
(weight 0 = punctured/erased).  Encoder assumes 4 zero flush bits, so
traceback starts from state 0.

The port's own copy of ``dsdneo_tpu/fec/conv.py`` (numpy only), unchanged in its
logic, so both packages give the same results bit for bit.
"""

from __future__ import annotations

import numpy as np

K = 5
NSTATES = 16


def _tables():
    # transition outputs: state s holds the last 4 input bits, s bit0 =
    # most recent.  out[s, b] = (o1, o2) for input bit b.
    o1 = np.zeros((NSTATES, 2), dtype=np.uint8)
    o2 = np.zeros((NSTATES, 2), dtype=np.uint8)
    nxt = np.zeros((NSTATES, 2), dtype=np.int64)
    for s in range(NSTATES):
        s0 = s & 1
        s1 = (s >> 1) & 1
        s2 = (s >> 2) & 1
        s3 = (s >> 3) & 1
        for b in range(2):
            o1[s, b] = b ^ s2 ^ s3
            o2[s, b] = b ^ s0 ^ s1 ^ s3
            nxt[s, b] = ((s << 1) | b) & 0xF
    return o1, o2, nxt


_O1, _O2, _NEXT = _tables()


def encode(bits: np.ndarray) -> np.ndarray:
    """Encode bits (+4 zero flush appended) → 2·(n+4) symbols."""
    data = np.concatenate([np.asarray(bits, dtype=np.uint8), np.zeros(4, np.uint8)])
    out = np.zeros(2 * data.shape[0], dtype=np.uint8)
    s = 0
    for i, b in enumerate(data):
        out[2 * i] = _O1[s, b]
        out[2 * i + 1] = _O2[s, b]
        s = _NEXT[s, b]
    return out


def encode_rows(bits: np.ndarray) -> np.ndarray:
    """Encode each row of ``[N, n]`` bits as it stands (no flush bits
    appended: the rows carry their own) → ``[N, 2n]`` float32 symbols,
    :func:`encode`'s state walk taken one step for every row at once."""
    bits = np.asarray(bits, dtype=np.int64)
    sym = np.zeros((bits.shape[0], 2 * bits.shape[1]), np.float32)
    st = np.zeros(bits.shape[0], np.int64)
    for i in range(bits.shape[1]):
        sym[:, 2 * i] = _O1[st, bits[:, i]]
        sym[:, 2 * i + 1] = _O2[st, bits[:, i]]
        st = _NEXT[st, bits[:, i]]
    return sym


def decode_soft(symbols: np.ndarray, weights: np.ndarray | None = None,
                nbits: int | None = None) -> np.ndarray:
    """Viterbi-decode 2N soft symbols (values in [0,1], or hard 0/1).

    weights: per-symbol confidence (0 = ignore).  Returns ``nbits``
    decoded bits (default N-4, dropping the flush bits).
    """
    sym = np.asarray(symbols, dtype=np.float32)
    n = sym.shape[0] // 2
    if weights is None:
        weights = np.ones(2 * n, dtype=np.float32)
    w = np.asarray(weights, dtype=np.float32)
    if nbits is None:
        nbits = n - 4

    INF = np.float32(1e30)
    metric = np.full(NSTATES, INF, dtype=np.float32)
    metric[0] = 0.0
    backptr = np.zeros((n, NSTATES), dtype=np.int8)

    # each new state t has exactly two predecessors: t>>1 and (t>>1)|8,
    # both consuming input bit t&1
    t = np.arange(NSTATES)
    pred_a = t >> 1
    pred_b = (t >> 1) | 8
    bit_in = t & 1
    for i in range(n):
        s0, s1 = sym[2 * i], sym[2 * i + 1]
        w0, w1 = w[2 * i], w[2 * i + 1]
        c = (np.abs(_O1.astype(np.float32) - s0) * w0
             + np.abs(_O2.astype(np.float32) - s1) * w1)  # [16,2] (state,bit)
        ca = metric[pred_a] + c[pred_a, bit_in]
        cb = metric[pred_b] + c[pred_b, bit_in]
        take_b = cb < ca
        metric = np.where(take_b, cb, ca)
        backptr[i] = np.where(take_b, pred_b, pred_a)

    st = 0  # flushed
    bits = np.zeros(n, dtype=np.uint8)
    for i in range(n - 1, -1, -1):
        prev = int(backptr[i, st])
        bits[i] = st & 1
        st = prev
    return bits[:nbits]
