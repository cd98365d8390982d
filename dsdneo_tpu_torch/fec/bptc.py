"""BPTC (Block Product Turbo Code) de/interleavers for DMR.

BPTC(196,96): 196 bits deinterleaved by i→(13·i mod 196), arranged as a
13×15 product matrix (bit 0 unused), rows 0-8 Hamming(15,11), columns
Hamming(13,9).  Payload = matrix[0][3:11] ‖ rows 1..8 cols 0..10.
(ETSI TS 102 361-1 B.1.1; reference parity: src/fec/bptc.c:51-140.)

Also the 32/64-bit variants for embedded signalling (B.2.1).

The port's own copy of ``dsdneo_tpu/fec/bptc.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import blockcodes


def deinterleave_196(bits: np.ndarray) -> np.ndarray:
    i = np.arange(196)
    out = np.zeros(196, dtype=bits.dtype)
    out[(i * 13) % 196] = bits
    return out


def interleave_196(bits: np.ndarray) -> np.ndarray:
    i = np.arange(196)
    return bits[(i * 13) % 196]


def bptc_196_96_decode(bits196: np.ndarray) -> tuple[np.ndarray, int]:
    """Decode a deinterleaved-order-agnostic received block.

    Input: raw 196 on-air bits.  Returns (96 payload bits, error count =
    number of row+column codewords needing correction beyond 1 bit).
    """
    d = deinterleave_196(np.asarray(bits196, dtype=np.uint8))
    mat = d[1:196].reshape(13, 15)
    errors = 0
    h15 = blockcodes.hamming_15_11()
    h13 = blockcodes.hamming_13_9()
    # rows 0..8 are Hamming(15,11) codewords
    for i in range(9):
        msg, errs = h15.decode(mat[i])
        if errs > 1:
            errors += 1
        mat[i, :11] = h15.codebook[msg][:11]
    # all 15 columns are Hamming(13,9) codewords
    for j in range(15):
        msg, errs = h13.decode(mat[:, j])
        if errs > 1:
            errors += 1
        mat[:9, j] = h13.codebook[msg][:9]
    payload = np.concatenate([mat[0, 3:11], mat[1:9, :11].reshape(-1)])
    return payload.astype(np.uint8), errors


def bptc_196_96_encode(bits96: np.ndarray) -> np.ndarray:
    """Encode 96 payload bits → 196 on-air bits (for tests/TX paths)."""
    h15 = blockcodes.hamming_15_11()
    h13 = blockcodes.hamming_13_9()
    mat = np.zeros((13, 15), dtype=np.uint8)
    mat[0, 3:11] = bits96[:8]
    mat[1:9, :11] = bits96[8:].reshape(8, 11)
    for i in range(9):
        msg = 0
        for b in mat[i, :11]:
            msg = (msg << 1) | int(b)
        mat[i] = h15.codebook[msg]
    for j in range(15):
        msg = 0
        for b in mat[:9, j]:
            msg = (msg << 1) | int(b)
        mat[:, j] = h13.codebook[msg]
    out = np.zeros(196, dtype=np.uint8)
    out[1:] = mat.reshape(-1)
    return interleave_196(out)


# -- embedded signalling BPTC(32,11) / (128,77) handled in dmr module ----
