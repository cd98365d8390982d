"""The bitwise CRCs of the LMR protocols (exact integer semantics).

The port's own copy of ``dsdneo_tpu/fec/crc.py`` (numpy only): CRC-16
(the P25 TSBK and the DMR block checks), CRC-12, CRC-9, CRC-8 and CRC-32,
unchanged in their logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

import numpy as np


def crc16_bits(bits: np.ndarray, poly: int = 0x1021, init: int = 0xFFFF,
               xorout: int = 0x0000) -> int:
    """Bitwise CRC-16 over a 0/1 bit array (msb-first)."""
    crc = init
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((crc >> 15) & 1) ^ int(b)
        crc = (crc << 1) & 0xFFFF
        if fb:
            crc ^= poly
    return crc ^ xorout


def crc12_bits(bits: np.ndarray, poly: int = 0x80F, init: int = 0x000,
               xorout: int = 0x000) -> int:
    crc = init
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((crc >> 11) & 1) ^ int(b)
        crc = (crc << 1) & 0xFFF
        if fb:
            crc ^= poly
    return crc ^ xorout


def crc9_bits(bits: np.ndarray, poly: int = 0x059, init: int = 0x000,
              xorout: int = 0x000) -> int:
    crc = init
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((crc >> 8) & 1) ^ int(b)
        crc = (crc << 1) & 0x1FF
        if fb:
            crc ^= poly
    return crc ^ xorout


def crc8_bits(bits: np.ndarray, poly: int = 0x07, init: int = 0x00,
              xorout: int = 0x00) -> int:
    crc = init
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((crc >> 7) & 1) ^ int(b)
        crc = (crc << 1) & 0xFF
        if fb:
            crc ^= poly
    return crc ^ xorout


def crc32_bits(bits: np.ndarray, poly: int = 0x04C11DB7, init: int = 0xFFFFFFFF,
               xorout: int = 0xFFFFFFFF) -> int:
    crc = init
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((crc >> 31) & 1) ^ int(b)
        crc = (crc << 1) & 0xFFFFFFFF
        if fb:
            crc ^= poly
    return crc ^ xorout
