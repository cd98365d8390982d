"""M17 host decoding: the frame randomizer and interleaver, the stream
puncture pattern, CRC-16 (0x5935) and the callsign code (host, numpy).

The port's own copy of what ``engine.m17batch`` reads from
``dsdneo_tpu/protocol/m17/decoder.py``: ``_SCRAMBLE``, ``_INTERLEAVE``,
``_P2``, ``DT_NAMES``, ``ENC_NAMES``, ``m17_crc16``, ``decode_callsign``
and ``_pack_bytes``.  A frame is an 8-symbol sync and 184 symbols (368
bits): derandomized, de-interleaved by π(i) = (45i + 92i²) mod 368; a
stream frame then holds a 96-bit LICH (4 × Golay(24,12) → a 40-bit LSF
chunk and a 3-bit counter) and a 272-bit P2-punctured payload (FN and
128 Codec2 bits, K=5 convolutional code).
"""

from __future__ import annotations

import numpy as np

# M17 spec randomizer sequence (46 bytes → 368 bits)
_SCRAMBLE = np.array([
    1,1,0,1,0,1,1,0,1,0,1,1,0,1,0,1,1,1,1,0,0,0,1,0,0,0,1,1,0,0,0,0,1,0,0,0,0,
    0,1,0,1,1,1,1,1,1,1,1,1,0,0,0,0,1,0,0,0,1,1,0,0,0,1,0,1,0,1,1,1,0,1,0,0,1,
    0,0,1,1,1,0,1,0,0,1,0,1,1,0,1,0,0,1,0,0,0,0,1,1,0,1,1,0,0,0,1,0,0,1,1,0,0,
    0,1,1,0,1,1,1,0,1,0,1,0,1,1,1,0,1,0,0,0,0,1,1,0,0,1,1,0,0,1,0,0,0,0,1,0,1,
    0,0,1,0,0,1,0,0,0,0,1,1,1,0,0,1,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1,1,1,0,0,0,0,
    1,1,0,1,1,1,0,0,1,1,0,1,0,0,0,0,0,1,0,1,1,1,1,0,0,1,1,0,1,0,1,1,1,0,1,1,0,
    1,0,0,0,0,1,0,1,0,0,1,1,1,0,1,0,1,0,1,1,0,0,1,1,0,1,0,1,1,1,0,1,1,0,0,0,0,
    1,1,0,0,1,1,0,0,0,1,1,0,1,1,1,0,1,0,1,0,1,1,0,0,0,0,0,0,0,1,1,0,1,0,0,0,1,
    0,0,1,1,0,0,1,1,1,0,0,0,0,1,1,1,0,0,0,1,0,0,1,1,0,1,0,1,0,1,1,1,0,0,0,1,1,
    0,0,0,0,0,1,0,1,1,0,1,0,0,1,0,1,0,0,1,0,1,1,1,1,0,0,0,1,1,0,0,0,0,1,1],
    dtype=np.uint8)

_INTERLEAVE = np.array([(45 * i + 92 * i * i) % 368 for i in range(368)],
                       dtype=np.int64)

_P2 = np.array([1,1,1,1,1,1,1,1,1,1,1,0], dtype=np.uint8)

BASE40 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-/."

DT_NAMES = {0: " Reserved", 1: " Data", 2: " Voice (3200bps)",
            3: " Voice (1600bps)"}
ENC_NAMES = {1: " Scrambler", 2: " AES-CTR"}


def m17_crc16(data: np.ndarray) -> int:
    """CRC-16 of M17 (polynomial 0x5935, init 0xFFFF) over bytes; 0 over
    a block that ends in its own CRC."""
    crc = 0xFFFF
    for byte in data:
        crc ^= int(byte) << 8
        for _ in range(8):
            crc <<= 1
            if crc & 0x10000:
                crc = (crc ^ 0x5935) & 0xFFFF
    return crc & 0xFFFF


def decode_callsign(value: int) -> str:
    """A 48-bit base-40 callsign code → its text."""
    if value == 0xFFFFFFFFFFFF:
        return "BROADCAST"
    if value == 0:
        return "RESERVED"
    out = []
    while value > 0:
        out.append(BASE40[value % 40])
        value //= 40
    return "".join(out)


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _pack_bytes(bits: np.ndarray) -> np.ndarray:
    """0/1 bits → bytes, most significant bit first."""
    n = len(bits) // 8
    return np.array([_bti(bits[i * 8:(i + 1) * 8]) for i in range(n)],
                    dtype=np.uint8)
