"""The RC4 keystream of P25 ADP voice.

The port's own copy of ``rc4_keystream`` in
``dsdneo_tpu/crypto/keystream.py``; host code, a byte at a time.
"""

from __future__ import annotations

import numpy as np


def rc4_keystream(key: bytes, n: int, drop: int = 0) -> np.ndarray:
    """``n`` RC4 keystream bytes of ``key`` after discarding the first
    ``drop``, as uint8."""
    s = list(range(256))
    j = 0
    for i in range(256):
        j = (j + s[i] + key[i % len(key)]) & 0xFF
        s[i], s[j] = s[j], s[i]
    out = np.zeros(n, dtype=np.uint8)
    i = j = 0
    for k in range(drop + n):
        i = (i + 1) & 0xFF
        j = (j + s[i]) & 0xFF
        s[i], s[j] = s[j], s[i]
        if k >= drop:
            out[k - drop] = s[(s[i] + s[j]) & 0xFF]
    return out
