"""The bitwise CRC-16 of the P25 TSBK check (exact integer semantics).

The port's own copy of ``crc16_bits`` from ``dsdneo_tpu/fec/crc.py``
(numpy only), unchanged in its logic, so both packages give the same
results bit for bit.  The module's other CRC widths join it with the
slices that use them.
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
