"""ASCII NMEA sentence validation shared by the P25 location-service
SAP, NXDN data calls, and DMR UDT binary payloads.

Reference parity: src/core/gps/dsd_gps.c nmea_validate_checksum
(:210-250; '$'/'!' start, XOR checksum of printable chars up to '*',
two hex digits after), nmea_copy_printable_sentence, and
nmea_print_invalid_reason.

The port's own copy of ``dsdneo_tpu/protocol/nmea.py`` (numpy only), unchanged in its
logic, so both packages give the same results bit for bit.
"""

from __future__ import annotations

import numpy as np


def nmea_sentence_check(body: np.ndarray) -> str:
    """Validate + render an ASCII NMEA sentence held in *body* bytes.
    Returns " NMEA: <sentence>" when the checksum verifies, else the
    reference's invalid-reason text."""
    b = np.asarray(body, dtype=np.uint8)
    if len(b) == 0 or int(b[0]) not in (0x24, 0x21):    # '$' or '!'
        return " Not an NMEA Sentence Structure;"
    csum, star = 0, -1
    for i in range(1, len(b)):
        v = int(b[i])
        if v == 0x2A:                                   # '*'
            star = i
            break
        if 0x20 <= v < 0x7F:
            csum ^= v
        else:
            break
    if star < 0 or star + 2 >= len(b):
        return " Possible NMEA Sentence, Missing Ending *;"
    try:
        ext = int(bytes(int(x) for x in b[star + 1:star + 3]), 16)
    except ValueError:
        return " Possible NMEA Sentence, Missing Ending *;"
    if ext != csum:
        return f" NMEA Checksum Error ({csum:02X} / {ext:02X});"
    text = "".join(chr(int(v)) if 0x20 <= int(v) < 0x7F else " "
                   for v in b).strip()
    return f" NMEA: {text}"
