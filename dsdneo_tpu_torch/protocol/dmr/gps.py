"""DMR GPS decoders: embedded LC (FLCO 0x08), UDT NMEA (IEC 61162-1
short/long), and ETSI Location Information Protocol (LIP).

Bit layouts + scaling per reference src/core/gps/dsd_gps.c:
dmr_embedded_gps (pos_err at bits 20-22, lon sign+24 bits at 23-47
unit 360/2^25, lat sign+23 bits at 48-71 unit 180/2^24, two's
complement signs), nmea_iec_61162_1 (:384-475), lip_protocol_decoder
(:288-369) with the v = 16·1.038^(K-13) velocity curve
(lip_velocity_kph :115-134).

The port's own copy of ``dsdneo_tpu/protocol/dmr/gps.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def decode_embedded_gps(lc_bits: np.ndarray) -> str:
    b = np.asarray(lc_bits, dtype=np.uint8)
    pos_err = _bti(b[20:23])
    lon_sign = int(b[23])
    lon = _bti(b[24:48])
    lat_sign = int(b[48])
    lat = _bti(b[49:72])
    latstr, lonstr = "N", "E"
    lat_sf = lon_sf = 1.0
    if lat_sign:
        lat = 0x800000 - lat
        latstr, lat_sf = "S", -1.0
    if lon_sign:
        lon = 0x1000000 - lon
        lonstr, lon_sf = "W", -1.0
    latitude = lat * (180.0 / 16777216.0)
    longitude = lon * (360.0 / 33554432.0)
    if pos_err <= 0x5:
        err = f" Err: {2 * 10 ** pos_err}m"
    elif pos_err == 0x6:
        err = " Err: >200km"
    else:
        err = " Unknown Pos Err"
    return (f"Embedded GPS: {latitude:.5f}{latstr}"
            f" {longitude:.5f}{lonstr}{err}")


def decode_nmea_iec(bits: np.ndarray, fmt: int) -> str:
    """UDT NMEA location (IEC 61162-1 packed form, reference
    dsd_gps.c nmea_iec_61162_1): fmt 1 = short (seconds in 10s),
    fmt 2 = long (1s seconds + course over ground).  *bits* start at
    the UDT payload (appended block bit 0)."""
    b = np.asarray(bits, dtype=np.uint8)
    if len(b) < 112:
        b = np.concatenate([b, np.zeros(112 - len(b), np.uint8)])
    ns, ew, q = int(b[1]), int(b[2]), int(b[3])
    speed = _bti(b[4:11])                      # knots
    ndeg, nmin, nminf = _bti(b[11:18]), _bti(b[18:24]), _bti(b[24:38])
    edeg, emin, eminf = _bti(b[38:46]), _bti(b[46:52]), _bti(b[52:66])
    hh, mm = _bti(b[66:71]), _bti(b[71:77])
    lat = ndeg + nmin / 60.0 + nminf / 600000.0
    lon = edeg + emin / 60.0 + eminf / 600000.0
    if not ns:                                 # 0 = South
        lat = -lat
    if not ew:                                 # 0 = West
        lon = -lon
    kph = speed * 1.852
    out = f" GPS: {lat:f}, {lon:f};"
    if speed > 126:
        out += f" SPD > 126 knots or {kph:f} kph;"
    else:
        out += f" SPD: {speed} knots; {kph:f} kph;"
    if fmt == 1:
        ss = _bti(b[77:80]) * 10
        out += f" FIX: {q}; {hh:02d}:{mm:02d}:{ss:02d} UTC; Short Format;"
    else:
        ss = _bti(b[77:83])
        cog = _bti(b[103:112])
        out += (f" FIX: {q}; {hh:02d}:{mm:02d}:{ss:02d} UTC;"
                f" COG: {cog}; Long Format;")
    return out


def _lip_velocity_kph(k: int) -> float:
    """ETSI TS 102 361-4 horizontal velocity: 1 km/h steps to 28,
    then v = 16·1.038^(K-13) (reference lip_velocity_kph)."""
    if k <= 28:
        return float(k)
    return 16.0 * 1.038 ** (min(k, 127) - 13)


def decode_lip(bits: np.ndarray) -> str:
    """ETSI Location Information Protocol short PDU (reference
    lip_protocol_decoder; TS 102 361-4 p208).  *bits* start at the
    UDT payload."""
    b = np.asarray(bits, dtype=np.uint8)
    if len(b) < 81:
        b = np.concatenate([b, np.zeros(81 - len(b), np.uint8)])
    lon_sign = int(b[8])
    lon = _bti(b[9:33])
    lat_sign = int(b[33])
    lat = _bti(b[34:57])
    hor_vel = _bti(b[59:66])
    dir_tra = _bti(b[66:70])
    add_hash = _bti(b[73:81])
    latstr, lonstr = "N", "E"
    if lat_sign:
        lat = 0x800000 - lat
        latstr = "S"
    if lon_sign:
        lon = 0x1000000 - lon
        lonstr = "W"
    latitude = lat * (180.0 / 16777216.0)
    longitude = lon * (360.0 / 33554432.0)
    if latitude > 90.0 or longitude > 180.0:
        return "Location Information Protocol;  Position Calculation Error;"
    vt = int(_lip_velocity_kph(hor_vel))
    dt = int((dir_tra + 11.25) / 22.5)
    return ("Location Information Protocol; "
            f"Src(Hash); {add_hash:03d};  Lat: {latitude:.5f}{latstr}"
            f" Lon: {longitude:.5f}{lonstr};"
            f" Spd: {vt} km/h; Dir: {dt}")


def decode_locn(payload) -> str | None:
    """Motorola MNIS LOCN token stream (reference dmr_pdu.c dmr_locn):
    'A' + 12 ASCII digits = hhmmss ddmmyy time, 'N'/'S' + latitude
    (2-digit deg, 2-digit min, skip, 4-digit fractional min in 1e-4
    units x 60), 'E'/'W' + longitude (3-digit deg).  Returns None when
    no complete position is present."""
    b = [int(x) for x in payload]
    n = len(b)

    def digits(i, k):
        v = 0
        for j in range(k):
            v = v * 10 + (b[i + j] - 0x30)
        return v

    time_s = None
    lat = lon = None
    i = 0
    while i < n:
        adv = 1
        t = b[i]
        if t == 0x41 and i + 12 < n:                 # 'A'
            hh, mi, ss = digits(i + 1, 2), digits(i + 3, 2), digits(i + 5, 2)
            dd, mo, yy = digits(i + 7, 2), digits(i + 9, 2), digits(i + 11, 2)
            if (1 <= mo <= 12 and 1 <= dd <= 31 and hh <= 23
                    and mi <= 59 and ss <= 59):
                time_s = f"20{yy:02d}/{mo:02d}/{dd:02d} {hh:02d}:{mi:02d}:{ss:02d}"
            adv = 13
        elif t in (0x4E, 0x53) and i + 9 < n:        # 'N'/'S'
            sign = -1.0 if t == 0x53 else 1.0
            lat = sign * (digits(i + 1, 2) + digits(i + 3, 2) / 60.0
                          + digits(i + 6, 4) / 600000.0)
            adv = 9
        elif t in (0x45, 0x57) and i + 10 < n:       # 'E'/'W'
            sign = -1.0 if t == 0x57 else 1.0
            lon = sign * (digits(i + 1, 3) + digits(i + 4, 2) / 60.0
                          + digits(i + 7, 4) / 600000.0)
            adv = 9
        i += adv
    if lat is None or lon is None:
        return None
    out = " NMEA / LOCN;"
    if time_s:
        out += f" {time_s}"
    return out + f" ({lat:.5f}, {lon:.5f});"
