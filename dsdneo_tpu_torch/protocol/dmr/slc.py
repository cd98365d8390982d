"""DMR CACH short link control (SLC) channel.

The 24-bit CACH carries a 7-bit TACT (Hamming(7,4)) and 17 payload
bits.  With LCSS 0 the payload is a self-contained single fragment
(Hamming(17,12,3)); otherwise four fragments assemble into a 68-bit
block that de-interleaves by (i*4) mod 67, passes three
Hamming(17,12,3) codes, compacts to 36 data bits, and is gated by a
CRC8 before SLCO dispatch.

Reference parity: src/protocol/dmr/dmr_flco.c dmr_cach (:1432-1477),
dmr_cach_process_final_fragment (:1443-1478 de-interleave + compact),
dmr_slco (:1788-1829) and the slco field decode (:1565-1631), with
Hamming17123/crc8 from dmr_utils.c (:158-205, OP25 lineage) and the
Tier III net/site display splits from dmr_tiii_site.h.

The port's own copy of ``dsdneo_tpu/protocol/dmr/slc.py`` (numpy only),
unchanged in its logic, so both packages give the same results bit for
bit.
"""

from __future__ import annotations

import numpy as np

# syndrome → flipped bit (reference kHamming17123Corrections)
_H17_FIX = {0x01: 12, 0x02: 13, 0x04: 14, 0x08: 15, 0x10: 16,
            0x1B: 0, 0x1F: 1, 0x17: 2, 0x07: 3, 0x0E: 4, 0x1C: 5,
            0x11: 6, 0x0B: 7, 0x16: 8, 0x05: 9, 0x0A: 10, 0x14: 11}

_ACTIVITY = {0x0: "Idle", 0x2: "Group CSBK", 0x3: "Ind CSBK",
             0x8: "Group Voice", 0x9: "Ind Voice", 0xA: "Ind Data",
             0xB: "Group Data", 0xC: "Group Emergency",
             0xD: "Ind Emergency"}

_MODELS = {0: ("Tiny", 9, 3), 1: ("Small", 7, 5),
           2: ("Large", 4, 8), 3: ("Huge", 2, 10)}


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def hamming17123(d: np.ndarray) -> bool:
    """Hamming(17,12,3) check/correct in place (reference
    dmr_utils.c Hamming17123)."""
    c = [d[0] ^ d[1] ^ d[2] ^ d[3] ^ d[6] ^ d[7] ^ d[9],
         d[0] ^ d[1] ^ d[2] ^ d[3] ^ d[4] ^ d[7] ^ d[8] ^ d[10],
         d[1] ^ d[2] ^ d[3] ^ d[4] ^ d[5] ^ d[8] ^ d[9] ^ d[11],
         d[0] ^ d[1] ^ d[4] ^ d[5] ^ d[7] ^ d[10],
         d[0] ^ d[1] ^ d[2] ^ d[5] ^ d[6] ^ d[8] ^ d[11]]
    n = 0
    for k in range(5):
        if int(c[k]) != int(d[12 + k]):
            n |= 1 << k
    if n == 0:
        return True
    fix = _H17_FIX.get(n)
    if fix is None:
        return False
    d[fix] ^= 1
    return True


def crc8_dmr(bits: np.ndarray, n: int) -> int:
    """Long-division CRC8, poly x^8+x^2+x+1, zero-padded (reference
    dmr_utils.c crc8)."""
    buf = list(int(b) for b in bits[:n]) + [0] * 8
    for i in range(n):
        if buf[i]:
            for j, p in enumerate((1, 0, 0, 0, 0, 0, 1, 1, 1)):
                buf[i + j] ^= p
    return _bti(buf[n:n + 8])


def _tiii_site(bits: np.ndarray) -> tuple[str, int, int, int]:
    """model label + display net/site/subsite (reference
    dmr_slco_fill_sys_fields + dmr_tiii_site.h with the default
    per-model subsite split)."""
    model = _bti(bits[4:6])
    name, net_bits, site_bits = _MODELS[model]
    net = _bti(bits[6:6 + net_bits])
    site = _bti(bits[6 + net_bits:6 + net_bits + site_bits])
    n = site_bits                       # default split == site width
    return (name, net + 1, (site >> n) + 1, (site & ((1 << n) - 1)) + 1)


def decode_slco(bits: np.ndarray) -> str:
    """Dispatch a 36-bit completed SLC block (reference dmr_slco)."""
    b = np.asarray(bits, dtype=np.uint8)
    slco = _bti(b[0:4])
    if slco == 0x0:
        return " SLCO NULL "
    if slco == 0x1:
        ts1, ts2 = _bti(b[4:8]), _bti(b[8:12])
        h1, h2 = _bti(b[12:20]), _bti(b[20:28])
        return (" Activity Update"
                f" TS1: {_ACTIVITY.get(ts1, f'Res {ts1:X}')}; Hash: {h1};"
                f" TS2: {_ACTIVITY.get(ts2, f'Res {ts2:X}')}; Hash: {h2};")
    if slco in (0x2, 0x3):
        name, net, site, sub = _tiii_site(b)
        syscode = _bti(b[4:18])
        reg = int(b[18])
        if slco == 0x2:
            csc = _bti(b[19:28])
            return (f" SLC_C_SYS_PARMS: {name}; Net ID: {net};"
                    f" Site ID: {site}.{sub}; Reg Req: {reg};"
                    f" CSC: {csc}; SYS: {syscode:04X};")
        return (f" SLC_P_SYS_PARMS: {name}; Net ID: {net};"
                f" Site ID: {site}.{sub}; Comp CC: {reg};"
                f" SYS: {syscode:04X};")
    if slco == 0x9:
        return (f" SLCO Connect Plus Traffic Channel -"
                f" Net ID: {_bti(b[8:16])} Site ID: {_bti(b[16:24])}")
    if slco == 0xA:
        return (f" SLCO Connect Plus Control Channel -"
                f" Net ID: {_bti(b[8:16])} Site ID: {_bti(b[16:24])}")
    if slco == 0xF:
        return (f" SLCO Capacity Plus Site: {_bti(b[22:25])}"
                f" - Rest LSN: {_bti(b[16:20])}"
                f" - RS: {_bti(b[20:22]):02X}")
    if slco == 0x8:
        return (f" SLCO Hytera XPT - Free LCN {_bti(b[12:16])}"
                f" - PRI LCN {_bti(b[16:20])}"
                f" - PRI HASH: {_bti(b[20:28]):02X}")
    return f" SLCO Unknown - {slco} "


class SlcAssembler:
    """Collects CACH SLC fragments keyed by the TACT LCSS field
    (reference dmr_cach: 1 = first, 3 = continue, 2 = last, 0 =
    single self-contained fragment)."""

    def __init__(self) -> None:
        self.frags = np.zeros((4, 17), np.uint8)
        self.counter = -1

    def feed(self, lcss: int, payload17: np.ndarray) -> str | None:
        p = np.asarray(payload17, dtype=np.uint8)[:17].copy()
        if lcss == 0:
            self.counter = -1
            if not hamming17123(p):
                return None
            return self._single(p)
        if lcss == 1:
            self.counter = 0
        elif lcss == 3:
            self.counter += 1
        elif lcss == 2:
            self.counter = 3
        if not 0 <= self.counter <= 3:
            self.counter = -1
            return None
        self.frags[self.counter] = p
        if lcss != 2:
            return None
        self.counter = -1
        return self._final()

    def _single(self, p: np.ndarray) -> str:
        slco = _bti(p[0:4])
        if slco == 0x0:
            return " SLCO NULL (single) "
        if slco == 0x1:
            ts1, ts2 = _bti(p[4:8]), _bti(p[8:12])
            return (f" SLC Activity (single)"
                    f" TS1: {_ACTIVITY.get(ts1, f'Res {ts1:X}')};"
                    f" TS2: {_ACTIVITY.get(ts2, f'Res {ts2:X}')};")
        if slco in (0x2, 0x3):
            name = _MODELS[_bti(p[4:6])][0]
            kind = "C" if slco == 0x2 else "P"
            return f" SLC {kind}_SYS_PARMS (single) Model={name}"
        if slco == 0x8:
            return " SLCO Hytera XPT (single)"
        if slco == 0x9:
            return " SLCO Connect Plus Traffic (single)"
        if slco == 0xA:
            return " SLCO Connect Plus Control (single)"
        return f" SLC (single) OPC=0x{slco:X} "

    def _final(self) -> str | None:
        raw = self.frags.reshape(-1)
        d = np.zeros(68, np.uint8)
        for i in range(67):
            d[i] = raw[(i * 4) % 67]
        d[67] = raw[67]
        ok = (hamming17123(d[0:17]) and hamming17123(d[17:34])
              and hamming17123(d[34:51]))
        # compact the three 12-bit data fields: 28 SLC bits + CRC8
        d[12:24] = d[17:29]
        d[24:36] = d[34:46]
        d[36:] = 0
        # the appended CRC8 sits inside the 36 bits, so a valid block
        # divides to zero (reference crc8_ok against the zeroed tail)
        if not ok or crc8_dmr(d, 36) != 0:
            return " SLCO CRC ERR"
        return decode_slco(d[:36])
