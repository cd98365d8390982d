"""DMR LRRP (Location Request/Response Protocol) parse → GPS fixes.

Token grammar and scaling per reference src/protocol/dmr/dmr_pdu.c
dmr_lrrp_parse_response_tokens / dmr_lrrp_compute_scaled: the PDU is
type byte + length byte + a token stream; position tokens 0x51/0x55/
0x66/0x69 carry signed 32-bit lat (x90/2^31) and lon (x180/2^31).

The port's own copy of ``dsdneo_tpu/protocol/dmr/lrrp.py`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_POSITION_TOKENS = {0x51: (11, 0), 0x55: (16, 1), 0x66: (9, 2), 0x69: (12, 3)}
_LEN1_TOKENS = {0x23, 0x31, 0x4A, 0x78, 0x61, 0x73}
_LEN0_TOKENS = {0x42, 0x3A, 0x50, 0x52, 0x54, 0x57, 0x62, 0x64, 0x38}

RESPONSE_TYPES = {0x07, 0x0D, 0x11, 0x13, 0x1F, 0x3F}
REQUEST_TYPES = {0x05, 0x09, 0x0F, 0x21}


@dataclass
class LrrpFix:
    have_pos: bool = False
    lat: float = 0.0
    lon: float = 0.0
    radius_m: float = 0.0
    have_rad: bool = False
    alt_m: float = 0.0
    have_alt: bool = False
    speed_mph: float = 0.0
    have_speed: bool = False
    heading_deg: int = 0
    have_heading: bool = False
    time: tuple | None = None
    known: int = 0
    unknown: int = 0
    truncated: int = 0
    rank: int = 99

    def describe(self) -> str:
        parts = []
        if self.time:
            y, mo, d, h, mi, s = self.time
            parts.append(f"Time: {y:04d}.{mo:02d}.{d:02d} {h:02d}:{mi:02d}:{s:02d}")
        if self.have_pos:
            parts.append(f"Lat: {self.lat:.5f} Lon: {self.lon:.5f}")
        if self.have_rad:
            parts.append(f"Radius: {self.radius_m:.2f}m")
        if self.have_alt:
            parts.append(f"Altitude: {self.alt_m:.2f}m")
        if self.have_speed:
            parts.append(f"Speed: {self.speed_mph:.2f} mph"
                         f" {self.speed_mph * 1.60934:.2f} km/h")
        if self.have_heading:
            parts.append(f"Track: {self.heading_deg}")
        return "; ".join(parts)


def _parse_tokens(pdu: np.ndarray, start: int, n: int) -> LrrpFix:
    r = LrrpFix()
    idx, remaining = start, n
    avail = len(pdu)
    while remaining > 0 and idx < avail:
        t = int(pdu[idx])
        need = 1
        if t == 0x22:                     # identity (len byte follows)
            need = 2 + int(pdu[idx + 1]) if remaining >= 2 else remaining
            r.known += 1
        elif t in _LEN1_TOKENS or t == 0x36:
            need = min(2, remaining)
            r.known += 1
        elif t in _LEN0_TOKENS:
            r.known += 1
        elif t == 0x34:                   # timestamp
            need = min(6, remaining)
            if need == 6 and r.time is None:
                p = pdu[idx:idx + 6].astype(np.int64)
                y = (int(p[1]) << 6) + (int(p[2]) >> 2)
                mo = ((int(p[2]) & 3) << 2) + ((int(p[3]) & 0xC0) >> 6)
                d = (int(p[3]) & 0x3E) >> 1
                h = ((int(p[3]) & 1) << 4) + ((int(p[4]) & 0xF0) >> 4)
                mi = ((int(p[4]) & 0xF) << 2) + ((int(p[5]) & 0xC0) >> 6)
                s = int(p[5]) & 0x3F
                if 2000 <= y <= 2037 and 1 <= mo <= 12 and 1 <= d <= 31 \
                        and h <= 23 and mi <= 59 and s <= 59:
                    r.time = (y, mo, d, h, mi, s)
            r.known += 1
        elif t == 0x37:                   # variable 2/3 bytes
            need = (3 if remaining >= 2 and pdu[idx + 1] & 0x80 else 2)
            need = min(need, remaining)
            r.known += 1
        elif t == 0x6C:                   # speed
            need = min(3, remaining)
            if need == 3 and not r.have_speed:
                r.speed_mph = ((int(pdu[idx + 1]) << 8) | int(pdu[idx + 2])) * 0.01
                r.have_speed = True
            r.known += 1
        elif t == 0x56:                   # heading
            need = min(2, remaining)
            if need == 2 and not r.have_heading:
                r.heading_deg = int(pdu[idx + 1]) * 2
                r.have_heading = True
            r.known += 1
        elif t in _POSITION_TOKENS:
            full, rank = _POSITION_TOKENS[t]
            need = min(full, remaining)
            if need == full and rank < r.rank:
                r.rank = rank
                lat_raw = int.from_bytes(bytes(int(x) for x in pdu[idx + 1:idx + 5]),
                                         "big", signed=True)
                lon_raw = int.from_bytes(bytes(int(x) for x in pdu[idx + 5:idx + 9]),
                                         "big", signed=True)
                r.lat = lat_raw * 90.0 / 2147483648.0
                r.lon = lon_raw * 180.0 / 2147483648.0
                r.have_pos = True
                if t in (0x51, 0x55):
                    r.radius_m = (((int(pdu[idx + 9]) << 8)
                                   | int(pdu[idx + 10])) * 0.01)
                    r.have_rad = True
                if t == 0x55:
                    r.alt_m = (((int(pdu[idx + 11]) << 8)
                                | int(pdu[idx + 12])) * 0.01)
                    r.have_alt = True
                if t == 0x69:
                    r.alt_m = (((int(pdu[idx + 9]) << 16)
                                | (int(pdu[idx + 10]) << 8)
                                | int(pdu[idx + 11])) * 0.01)
                    r.have_alt = True
            r.known += 1
        else:
            r.unknown += 1
        if need < 1:
            need = 1
        idx += need
        remaining -= need
    return r


def _score(r: LrrpFix, skip: int) -> int:
    score = -skip * 5 + r.known * 10 - r.unknown - r.truncated * 50
    if r.have_pos:
        score += 1000 - r.rank * 10
        if r.lat == 0.0 and r.lon == 0.0:
            score -= 900
    return score


def parse_lrrp(pdu: np.ndarray) -> LrrpFix | None:
    """Parse an LRRP PDU (type byte + length + tokens); tries small
    prefix skips and keeps the best-scoring parse (reference
    dmr_lrrp_parse_best_response)."""
    pdu = np.asarray(pdu, dtype=np.uint8)
    if len(pdu) < 4:
        return None
    token_len = min(int(pdu[1]), max(len(pdu) - 2, 0))
    best, best_score = None, -10 ** 6
    for skip in range(0, min(6, token_len) + 1):
        r = _parse_tokens(pdu, 2 + skip, token_len - skip)
        sc = _score(r, skip)
        if sc > best_score:
            best, best_score = r, sc
    if best is None or not (best.have_pos or best.time):
        return None
    return best


def looks_like_lrrp(pdu: np.ndarray) -> bool:
    pdu = np.asarray(pdu, dtype=np.uint8)
    if len(pdu) < 4:
        return False
    if int(pdu[0]) in RESPONSE_TYPES | REQUEST_TYPES:
        tl = min(int(pdu[1]), len(pdu) - 2)
        return any(int(b) in _POSITION_TOKENS or int(b) == 0x34
                   for b in pdu[2:2 + tl])
    return False
