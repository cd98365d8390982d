"""L3Harris vendor payloads shared by the P25 Phase 1 LCW and Phase 2
MAC paths: talker GPS and the talker alias.

The port's own copy of ``dsdneo_tpu/protocol/p25/harris.py``
(reference src/core/gps/dsd_gps.c nmea_harris, :477-560: the GPS fields
start at bit 40 of the assembled buffer; src/core/util/dsd_alias.c
l3h_embedded_alias_*: the MAC message 0xA8 carries the alias text from
byte 4; the Phase 1 LCW carries four 7-byte fragments, 0x32-0x35,
which ``HarrisAliasAssembler`` collects).
"""

from __future__ import annotations

import numpy as np


def _f(bits, a, n) -> int:
    v = 0
    for b in bits[a:a + n]:
        v = (v << 1) | int(b)
    return v


def decode_harris_gps(bits: np.ndarray) -> str:
    """Harris talker GPS; *bits* carry the GPS fields at bit offset 40
    (reference nmea_harris: P1 concatenates the two 56-bit LC blocks
    at +40, the P2 MAC structure places them at 16+24 == 40).
    Degrees/minutes/1e-4-minutes with hemisphere flags, seconds since
    midnight UTC (17 bits), and a 9-bit heading."""
    b = np.asarray(bits, dtype=np.uint8)
    if len(b) < 184:
        b = np.concatenate([b, np.zeros(184 - len(b), np.uint8)])
    g = 40
    lat_frac = _f(b, g + 0, 16)
    lat_hemi = int(b[g + 16])
    lat_min = _f(b, g + 17, 7)
    lat_deg = _f(b, g + 24, 8)
    lon_frac = _f(b, g + 32, 16)
    lon_hemi = int(b[g + 48])
    lon_min = _f(b, g + 49, 7)
    lon_deg = _f(b, g + 56, 8)
    lat = lat_deg + (lat_min + lat_frac / 10000.0) / 60.0
    lon = lon_deg + (lon_min + lon_frac / 10000.0) / 60.0
    if lat_hemi:
        lat = -lat
    if lon_hemi:
        lon = -lon
    if abs(lat) > 90.0 or abs(lon) > 180.0:
        return " Harris GPS: Invalid Position;"
    seconds = _f(b, g + 64, 16)
    if int(b[g + 80]):
        seconds += 65536
    seconds %= 86400
    heading = _f(b, g + 95, 9)
    return (f" Harris GPS: {lat:.6f}, {lon:.6f};"
            f" HEADING: {heading:03d};"
            f" TIME: {seconds // 3600:02d}:{seconds % 3600 // 60:02d}"
            f":{seconds % 60:02d} UTC;")


def sanitize_alias_char(v: int) -> str:
    """Reference l3h_alias_sanitize_char: comma → dot, controls →
    space, NUL ends the text."""
    if v == 0x2C:
        return "."
    if 0x19 < v < 0x7F:
        return chr(v)
    return "" if v == 0 else " "


class HarrisAliasAssembler:
    """Phase-1 fragment collection (LCW opcodes 0x32-0x35, 7 alias
    bytes each at bits 16+; reference
    l3h_embedded_alias_blocks_phase1).  Fragment 0 restarts the set;
    continuations without it are dropped.  Returns the assembled text
    once fragments 0-1 are in (reference decodes incrementally) and
    clears after fragment 3."""

    def __init__(self) -> None:
        self.frags: list[bytes | None] = [None] * 4

    def add(self, op: int, bits: np.ndarray) -> str | None:
        ptr = op - 0x32
        if not 0 <= ptr <= 3:
            return None
        raw = bytes(_f(bits, 16 + 8 * i, 8) for i in range(7))
        if ptr == 0:
            self.frags = [None] * 4
        elif self.frags[0] is None:
            return None
        self.frags[ptr] = raw
        text = None
        if self.frags[0] is not None and self.frags[1] is not None:
            # skip a second pair that just repeats the first
            # (l3h_alias_is_repeated_pair_fragment)
            parts = []
            for i, fr in enumerate(self.frags):
                if fr is None:
                    continue
                if i >= 2 and fr == self.frags[i - 2]:
                    continue
                parts.append(fr)
            text = "".join(sanitize_alias_char(v)
                           for fr in parts for v in fr).strip()
        if ptr == 3:
            self.frags = [None] * 4
        return text or None
