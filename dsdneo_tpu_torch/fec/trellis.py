"""The P25 1/2-rate trellis code: encoder, Viterbi and list decoders.

The P25 1/2-rate code (TIA-102.BAAA 5.3) maps each data dibit (which is
also the encoder state) to a 4-bit constellation nibble selected by
(previous state, next state); 49 steps cover 48 data dibits + flush.
The 98-dibit interleave is the standard P25 data interleave schedule.
Reference parity: src/protocol/p25/p25_12.c.

Host path is an exact Viterbi in numpy; the device path
(``fec.device.p25_12_decode_batch``, kernel K4 on the card) runs the
same 4-state lattice over a batch of words.

The port's own copy of ``dsdneo_tpu/fec/trellis.py`` (numpy only), unchanged in its
logic, so both packages give the same results bit for bit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# (prev_state<<2 | next_state) -> transmitted nibble (dibit pair), per the
# P25 trellis state-transition matrix (TIA-102.BAAA table; same constant
# table in reference src/protocol/p25/p25_12.c:19).
P25_DTM = np.array([2, 12, 1, 15, 14, 0, 13, 3, 9, 7, 10, 4, 5, 11, 6, 8],
                   dtype=np.uint8)


@lru_cache(maxsize=None)
def interleave_98() -> np.ndarray:
    """P25/DMR 98-dibit interleave schedule: received dibit i carries
    deinterleaved position ``interleave_98()[i]``."""
    seq = []
    for base in (0, 2, 4, 6):
        for k in range(13):
            for off in (0, 1):
                v = base + 8 * k + off
                if v <= 97:
                    seq.append(v)
    out = np.array(seq, dtype=np.int64)
    assert out.shape[0] == 98 and len(set(out.tolist())) == 98
    return out


def p25_12_encode(bits96: np.ndarray) -> np.ndarray:
    """96 data bits → one 196-bit trellis block (for loopback tests)."""
    data = np.asarray(bits96, dtype=np.uint8)
    dibits = (data[0::2] << 1) | data[1::2]
    states = list(dibits) + [0]              # flush step
    dei = np.zeros(98, dtype=np.uint8)
    prev = 0
    for i, s in enumerate(states):
        nib = int(P25_DTM[(prev << 2) | int(s)])
        dei[2 * i] = (nib >> 2) & 3
        dei[2 * i + 1] = nib & 3
        prev = int(s)
    tx = dei[interleave_98()]
    out = np.zeros(196, dtype=np.uint8)
    out[0::2] = (tx >> 1) & 1
    out[1::2] = tx & 1
    return out


def p25_12_decode(bits196: np.ndarray, llr196: np.ndarray | None = None
                  ) -> tuple[np.ndarray, int]:
    """Decode one 196-bit P25 1/2-rate trellis block → (96 data bits,
    path cost).  Soft decoding when ``llr196`` (positive = bit 0 more
    likely... sign convention: llr > 0 ⇒ bit=0) is given.
    """
    if llr196 is None:
        llr196 = (1 - 2 * bits196.astype(np.int32)) * 64  # hard → ±64
    llr = np.zeros(196, dtype=np.int64)
    il = interleave_98()
    llr[il * 2] = llr196[0::2]
    llr[il * 2 + 1] = llr196[1::2]

    # per-step cost of each expected nibble: cost(bit=1) = max(llr,0) etc.
    steps = llr.reshape(49, 4)
    # cost_table[step, nibble] = sum over 4 bits
    nibbles = ((np.arange(16)[:, None] >> np.arange(3, -1, -1)[None, :]) & 1)  # [16,4]
    pos = np.maximum(steps, 0)    # cost if expected bit is 1
    neg = np.maximum(-steps, 0)   # cost if expected bit is 0
    cost_table = (nibbles[None] * pos[:, None, :] + (1 - nibbles[None]) * neg[:, None, :]).sum(-1)  # [49,16]

    INF = np.int64(1 << 60)
    metric = np.full(4, INF, dtype=np.int64)
    metric[0] = 0
    metric[1:] = 256  # mild bias toward the specified start state
    backptr = np.zeros((49, 4), dtype=np.int8)
    expect = P25_DTM[(np.arange(4)[:, None] << 2) | np.arange(4)[None, :]]  # [prev, next]
    for i in range(49):
        cand = metric[:, None] + cost_table[i][expect]
        backptr[i] = np.argmin(cand, axis=0)
        metric = np.min(cand, axis=0)

    st = int(np.argmin(metric))
    cost = int(np.min(metric))
    states = np.zeros(49, dtype=np.uint8)
    for i in range(48, -1, -1):
        states[i] = st
        st = int(backptr[i, st])
    data_dibits = states[:48]
    bits = np.zeros(96, dtype=np.uint8)
    bits[0::2] = (data_dibits >> 1) & 1
    bits[1::2] = data_dibits & 1
    return bits, cost


MAX_CANDIDATES = 8


def p25_12_decode_list(bits196: np.ndarray,
                       llr196: np.ndarray | None = None,
                       max_candidates: int = MAX_CANDIDATES
                       ) -> list[tuple[np.ndarray, int]]:
    """List Viterbi: ranked candidate decodes of one 196-bit block.

    Keeps the ``max_candidates`` best survivors per trellis state (the
    reference's p25_12_soft_llr_list, src/protocol/p25/p25_12.c:144-204,
    with its exact ordering semantics: survivors insert before the first
    strictly-worse metric, so equal metrics preserve generation order —
    lower previous state, then lower rank).  Returns deduplicated
    [(bits96, metric)] sorted best-first; consumers try candidates in
    order until an outer CRC passes (p25p1_tsbk.c:128,
    tsbk_select_crc_candidate).
    """
    if llr196 is None:
        llr196 = (1 - 2 * np.asarray(bits196, dtype=np.int64)) * 64
    M = min(max_candidates, MAX_CANDIDATES)
    llr = np.zeros(196, dtype=np.int64)
    il = interleave_98()
    llr[il * 2] = llr196[0::2]
    llr[il * 2 + 1] = llr196[1::2]
    steps = llr.reshape(49, 4)
    nibbles = ((np.arange(16)[:, None] >> np.arange(3, -1, -1)[None, :]) & 1)
    pos = np.maximum(steps, 0)
    neg = np.maximum(-steps, 0)
    cost_table = (nibbles[None] * pos[:, None, :]
                  + (1 - nibbles[None]) * neg[:, None, :]).sum(-1)  # [49,16]
    expect = P25_DTM[(np.arange(4)[:, None] << 2) | np.arange(4)[None, :]]

    INF = 1 << 62
    prev = [[INF] * M for _ in range(4)]
    for st in range(4):
        prev[st][0] = 0 if st == 0 else 256
    backptr = np.zeros((49, 4, M), dtype=np.int16)   # (prev_state<<3)|rank

    for i in range(49):
        cur = [[INF] * M for _ in range(4)]
        for st_prev in range(4):
            for st_next in range(4):
                cost = int(cost_table[i][expect[st_prev, st_next]])
                lst = cur[st_next]
                bp = backptr[i, st_next]
                for rank in range(M):
                    pm = prev[st_prev][rank]
                    if pm >= INF:
                        continue
                    cand = pm + cost
                    # insert before the first strictly-worse survivor
                    at = -1
                    for k in range(M):
                        if cand < lst[k]:
                            at = k
                            break
                    if at < 0:
                        continue
                    lst[at + 1:] = lst[at:-1]
                    bp[at + 1:] = bp[at:-1].copy()
                    lst[at] = cand
                    bp[at] = (st_prev << 3) | rank
        prev = cur

    out: list[tuple[np.ndarray, int]] = []
    seen: set[bytes] = set()
    entries = []
    for st in range(4):
        for rank in range(M):
            if prev[st][rank] >= INF:
                continue
            states = np.zeros(49, dtype=np.uint8)
            s, r = st, rank
            for i in range(48, -1, -1):
                states[i] = s
                p = int(backptr[i, s, r])
                s, r = (p >> 3) & 3, p & 7
            key = states[:48].tobytes()
            if key in seen:
                continue
            seen.add(key)
            entries.append((prev[st][rank], len(entries), states[:48]))
    # stable sort by metric (insertion order preserved on ties)
    entries.sort(key=lambda e: (e[0], e[1]))
    for metric, _, dd in entries[:max_candidates]:
        bits = np.zeros(96, dtype=np.uint8)
        bits[0::2] = (dd >> 1) & 1
        bits[1::2] = dd & 1
        out.append((bits, int(metric)))
    return out
