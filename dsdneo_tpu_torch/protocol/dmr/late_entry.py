"""DMR late entry: mid-call MI recovery + per-superframe MI advance.

Encrypted DMR voice embeds the 32-bit MI (+ CRC4) in the first four
C3 bits of every voice frame: VC1-VC3 carry the three 12-bit Golay
message halves, VC4-VC6 the parities, packed column-major across the
three frames of each burst (reference src/fec/dmr_late_entry.c
dsd_dmr_late_entry_decode, collection src/protocol/dmr/dmr_le.c
dmr_late_entry_mi_fragment).  After each superframe the RC4 MI advances
through a 32-bit LFSR (src/crypto/dmr_mi.c dmr_mi_advance32) and the
keystream drop resets to 256 (dmr_alg_refresh_slot).

The port's own copy of ``dsdneo_tpu/protocol/dmr/late_entry.py`` (numpy
only), unchanged in its logic, so both packages give the same results
bit for bit.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import blockcodes


def crc4(bits: np.ndarray) -> int:
    """CRC4 poly 10011, final XOR 0xF (reference dsd_dmr_crc4)."""
    work = np.concatenate([np.asarray(bits, np.uint8),
                           np.zeros(4, np.uint8)])
    poly = np.array([1, 0, 0, 1, 1], np.uint8)
    for i in range(len(bits)):
        if work[i]:
            work[i:i + 5] ^= poly
    out = 0
    for i in range(4):
        out = (out << 1) | int(work[len(bits) + i])
    return out ^ 0xF


def _pack_fragments(frags: np.ndarray, base: int) -> int:
    """Column-major nibble pack of fragments[base..base+2][0..2]
    (reference dmr_late_entry_pack_fragments)."""
    packed = 0
    for col in range(3):
        for row in range(3):
            packed = (packed << 4) | (int(frags[base + row][col]) & 0xF)
    return packed


def late_entry_decode(frags: np.ndarray) -> tuple[int, bool, bool]:
    """fragments[7][3] (4-bit nibbles per voice frame, indexed by VC)
    → (mi32, crc_ok, all_golay_pass)."""
    mi_cw = _pack_fragments(frags, 1)
    par_cw = _pack_fragments(frags, 4)
    gol = blockcodes.golay_24_12()
    mi_bits = np.zeros(36, np.uint8)
    all_pass = True
    for t in range(3):
        cw = np.zeros(24, np.uint8)
        for bit in range(12):
            sh = bit + 12 * t
            cw[bit] = (mi_cw >> (35 - sh)) & 1
            cw[bit + 12] = (par_cw >> (35 - sh)) & 1
        msg, errs = gol.decode(cw)
        if errs > 3:
            all_pass = False
        mi_bits[12 * t:12 * (t + 1)] = gol.codebook[msg][:12]
    mi = 0
    for i in range(32):
        mi = (mi << 1) | int(mi_bits[i])
    rx_crc = 0
    for i in range(32, 36):
        rx_crc = (rx_crc << 1) | int(mi_bits[i])
    return mi, rx_crc == crc4(mi_bits[:32]), all_pass


def late_entry_encode(mi: int) -> np.ndarray:
    """Inverse of late_entry_decode for loopback tests: MI → [7][3]
    nibble fragments (index 0 unused, like the reference's VC indexing)."""
    gol = blockcodes.golay_24_12()
    bits = np.zeros(36, np.uint8)
    for i in range(32):
        bits[i] = (mi >> (31 - i)) & 1
    c = crc4(bits[:32])
    for i in range(4):
        bits[32 + i] = (c >> (3 - i)) & 1
    frags = np.zeros((7, 3), np.uint8)
    mi_packed = 0
    par_packed = 0
    for t in range(3):
        msg = 0
        for b in bits[12 * t:12 * (t + 1)]:
            msg = (msg << 1) | int(b)
        cw = gol.codebook[msg]
        for bit in range(12):
            mi_packed |= int(cw[bit]) << (35 - (bit + 12 * t))
            par_packed |= int(cw[12 + bit]) << (35 - (bit + 12 * t))
    for col in range(3):
        for row in range(3):
            sh = 4 * (8 - (3 * col + row))
            frags[1 + row][col] = (mi_packed >> sh) & 0xF
            frags[4 + row][col] = (par_packed >> sh) & 0xF
    return frags


def mi_advance32(mi: int) -> int:
    """32-step LFSR advance of the RC4 MI between superframes
    (reference dmr_mi_advance32: taps 31, 3, 1)."""
    lfsr = mi & 0xFFFFFFFF
    for _ in range(32):
        bit = ((lfsr >> 31) ^ (lfsr >> 3) ^ (lfsr >> 1)) & 1
        lfsr = ((lfsr << 1) | bit) & 0xFFFFFFFFFFFFFFFF
    return lfsr & 0xFFFFFFFF
