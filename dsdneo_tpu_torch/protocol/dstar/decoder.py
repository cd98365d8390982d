"""D-STAR (GMSK 4800 bps, 2-level) voice + slow-data decoder.

Frame model (JARL D-STAR; reference parity src/protocol/dstar/dstar.c):
21 voice frames per sync period — each frame is 72 voice bits + 24
slow-data bits, with the 21st frame's data field replaced by the frame
sync.  The 20×24 = 480 slow-data bits carry 60 bytes of 6-byte blocks
(XOR-scrambled with the repeating 24-bit pattern 0x0EF2C9): radio text,
a DPRS position, or a copy of the 41-byte RF header (flags +
RPT2/RPT1/URCALL/MYCALL + CRC-16/X25) when the block type is 0x55
(reference src/protocol/dstar/dstar_slow_data.c).  The RF header after
its own sync is 660 scrambled, interleaved bits of a rate-1/2 K=3 code.

Bit convention: 2-level positive polarity maps symbol > 0 → bit 0
(reference src/core/frames/dsd_dibit.c store_two_level_dibit).

The port's own copy of ``dsdneo_tpu/protocol/dstar/decoder.py`` (numpy
only), unchanged in its logic, so both packages give the same results
bit for bit.  ``engine.dstarbatch`` calls the header scrambler, the
CRC-16/X25 and the event lines of the header and the slow data from
here; the AMBE 3600x2400 ECC and ``voicing_activity`` are in
``protocol/dstar/ambe2400.py``.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                            ProtocolDecoder, register)
# engine.dstarbatch reads the voicing field through this module
from dsdneo_tpu_torch.protocol.dstar.ambe2400 import (  # noqa: F401
    voicing_activity)
from dsdneo_tpu_torch.symbols.framesync import SyncHit

# first 24 bits of the D-STAR scrambling sequence (x^7+x^4+1 LFSR), as a
# repeating XOR pattern for the slow-data bytes
SD_SCRAMBLE = np.array([0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1,
                        0, 0, 1, 0, 1, 1, 0, 0, 1, 0, 0, 1], dtype=np.uint8)


def _header_scramble() -> np.ndarray:
    """127-bit PN from the x⁷+x⁴+1 LFSR, seed 0x07, MSb out (reference
    dstar_header_utils.c dstar_fill_scrambler_sequence)."""
    reg = 0x07
    out = np.zeros(127, dtype=np.uint8)
    for i in range(127):
        out[i] = (reg >> 6) & 1
        fb = ((reg >> 6) ^ (reg >> 3)) & 1
        reg = ((reg << 1) & 0x7E) | fb
    return out


# rate-1/2 K=3 trellis (G1=x²+x+1, G2=x²+1): next-state ← (prev, ref1, ref0)
_V_TRANS = {0: ((0, 0, 0), (2, 1, 1)), 1: ((0, 1, 1), (2, 0, 0)),
            2: ((1, 1, 0), (3, 0, 1)), 3: ((1, 0, 1), (3, 1, 0))}
_V_DECODED = [0, 1, 0, 1]


def _viterbi_k3(coded: np.ndarray) -> np.ndarray:
    """660 hard bits (pairs s1,s0) → 330 info bits (reference
    dstar_header_utils.c dstar_header_viterbi_decode_soft)."""
    n = len(coded) // 2
    metric = np.zeros(4, dtype=np.int64)
    memory = np.zeros((4, n), dtype=np.uint8)
    for t in range(n):
        s1, s0 = int(coded[2 * t]), int(coded[2 * t + 1])
        new = np.zeros(4, dtype=np.int64)
        for ns in range(4):
            (pa, a1, a0), (pb, b1, b0) = _V_TRANS[ns]
            ma = metric[pa] + (s1 ^ a1) + (s0 ^ a0)
            mb = metric[pb] + (s1 ^ b1) + (s0 ^ b0)
            if ma <= mb:
                new[ns], memory[ns, t] = ma, 0
            else:
                new[ns], memory[ns, t] = mb, 1
        metric = new
    state = int(np.argmin(metric))
    out = np.zeros(n, dtype=np.uint8)
    prev0, prev1 = [0, 0, 1, 1], [2, 2, 3, 3]
    for t in range(n - 1, -1, -1):
        out[t] = _V_DECODED[state]
        state = (prev1 if memory[state, t] else prev0)[state]
    return out


def crc16_x25(data: np.ndarray) -> int:
    """CRC-16/X25 (poly 0x8408 reflected, init/xorout 0xFFFF), returned
    byte-swapped as the reference's dstar_crc16 does."""
    crc = 0xFFFF
    for byte in data:
        crc ^= int(byte)
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ 0x8408
            else:
                crc >>= 1
    crc = (~crc) & 0xFFFF
    return ((crc << 8) | (crc >> 8)) & 0xFFFF


def _ascii(b: np.ndarray) -> str:
    return "".join(chr(int(c)) if 0x20 <= c <= 0x7E else " " for c in b)


def _sd_ascii(sd_bytes) -> str:
    """Printable payload chars, skipping every 6th (block header)
    byte (reference dstar_sd_emit_truncated_ascii)."""
    out = []
    for i in range(1, 59):
        if i % 6 == 0:
            continue
        b = int(sd_bytes[i])
        if 0x19 < b < 0x7E + 1:
            out.append(chr(b))
    return "".join(out).strip()


def _sd_aprs(sd_bytes) -> str:
    """DPRS position from a $$CRC sentence: '!' marker then
    ddmm.ssh/dddmm.ssh (reference dstar_sd_handle_aprs +
    print_aprs_lat/lon)."""
    aprs = []
    for i in range(1, 60):
        if i % 6 == 0:
            continue
        aprs.append(int(sd_bytes[i]))
    start = -1
    for i in range(30, 40):
        if i < len(aprs) and aprs[i] == 0x21:      # '!'
            start = i + 1
            break
    if start < 0 or start + 18 >= len(aprs):
        return ""

    def take(n, skip=0):
        nonlocal start
        v = "".join(chr(c) if 0x19 < c < 0x7F else "?"
                    for c in aprs[start:start + n])
        start += n + skip
        return v

    lat_d = take(2)
    lat_m = take(2, 1)
    lat_s = take(2)
    ns = chr(aprs[start]) if aprs[start] in (0x4E, 0x53) else "?"
    start += 2                                 # hemisphere + '/'
    lon_d = take(3)
    lon_m = take(2, 1)
    lon_s = take(2)
    ew = chr(aprs[start]) if aprs[start] in (0x45, 0x57) else "?"
    return (f"APRS - Lat: {lat_d}d {lat_m}m {lat_s}s {ns}"
            f" ; Lon: {lon_d}d {lon_m}m {lon_s}s {ew} ;")


def slow_data_line(sd_bytes: np.ndarray, ctx: DecoderContext) -> str:
    """60 descrambled slow-data bytes → the event-line payload (radio
    text, a DPRS position, or the RF header's copy)."""
    if sd_bytes[0] == 0x40:
        # 20-char radio text in 5-byte blocks (reference
        # dstar_sd_handle_text_message)
        txt = _sd_ascii(sd_bytes)
        ctx.state.dstar_text = txt
        return f"SLOW DATA TEXT: {txt}"
    if sd_bytes[0] == 0x35:
        # fixed form: type field "$$CRC" → DPRS/APRS position
        # (reference dstar_sd_handle_fixed_form / handle_aprs)
        kind = "".join(chr(b) if 0x19 < b < 0x7F else " "
                       for b in sd_bytes[1:7])
        if kind.startswith("$$CRC"):
            gps = _sd_aprs(sd_bytes)
            if gps:
                ctx.state.dstar_gps = gps
                return f"SLOW DATA DATA: {_sd_ascii(sd_bytes)}\n {gps}"
            return f"SLOW DATA DATA: {_sd_ascii(sd_bytes)}"
        return f"SLOW DATA TEXT: {_sd_ascii(sd_bytes)}"
    if sd_bytes[0] != 0x55:
        return "SLOW DATA"
    blk = int(sd_bytes[0] & 0xF) + 1
    hd = np.zeros(60, dtype=np.uint8)
    j = 0
    for i in range(50):
        j += 1
        hd[i] = sd_bytes[j] if j < 60 else 0
        for marker in range(1, 10):
            if j == blk * marker - 1:
                j += 1
    crc_ext = (int(hd[39]) << 8) | int(hd[40])
    crc_cmp = crc16_x25(hd[:39])
    if crc_cmp != crc_ext:
        return "SLOW DATA - HEADER FORMAT (CRC ERR)"
    rpt2 = _ascii(hd[3:11]).strip()
    rpt1 = _ascii(hd[11:19]).strip()
    dst = _ascii(hd[19:27])
    src = _ascii(hd[27:39])
    ctx.state.last_src = src.strip()
    flags = int(hd[0])
    flagstr = ""
    for bit, name in ((0x80, " DATA"), (0x40, " REPEATER"),
                      (0x20, " INTERRUPTED"), (0x10, " CONTROL SIGNAL"),
                      (0x08, " URGENT")):
        if flags & bit:
            flagstr += name
    return (f"RPT 2: {rpt2} RPT 1: {rpt1} DST: {dst} SRC: {src}{flagstr}")


def header_line(hdr: np.ndarray, ctx: DecoderContext
                ) -> tuple[str, bool, dict]:
    """41 RF-header octets → (event-line payload, crc_ok, fields)."""
    crc_ext = (int(hdr[39]) << 8) | int(hdr[40])
    crc_cmp = crc16_x25(hdr[:39])
    rpt2 = _ascii(hdr[3:11])
    rpt1 = _ascii(hdr[11:19])
    dst = _ascii(hdr[19:27])
    src = _ascii(hdr[27:39])
    flags = ""
    for bit, name in ((0x80, " DATA"), (0x40, " REPEATER"),
                      (0x20, " INTERRUPTED"), (0x10, " CONTROL SIGNAL"),
                      (0x08, " URGENT")):
        if hdr[0] & bit:
            flags += name
    crc_ok = crc_cmp == crc_ext
    tag = "" if crc_ok else " (CRC ERR)"
    if crc_ok:
        ctx.state.last_src = src.strip()
    line = (f"RPT 2: {rpt2} RPT 1: {rpt1} DST: {dst} SRC: {src}"
            f"{flags}{tag}")
    return line, crc_ok, dict(rpt1=rpt1, rpt2=rpt2, dst=dst, src=src)


@register("dstar")
class DstarDecoder(ProtocolDecoder):
    protocol = "dstar"

    def _bits(self, reader: DibitReader, start: int, n: int) -> np.ndarray | None:
        """n symbols → n bits (2-level: dibit 3 → 1, dibit 1 → 0)."""
        if start < 0 or start + n > len(reader.dibits):
            return None
        dd = reader.dibits[start:start + n].astype(np.uint8)
        bits = ((dd >> 1) & 1)          # dibit 3/2 (negative symbol) → 1
        if reader.invert:
            bits = bits ^ 1
        return bits.astype(np.uint8)

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        if hit.sync.kind == "hd":
            return self._header(reader, hit, ctx)
        return self._voice(reader, hit, ctx)

    def _voice(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        pos = hit.end
        sd_bits = []
        voice = []
        for j in range(21):
            v = self._bits(reader, pos, 72)
            if v is None:
                return len(reader.dibits)
            voice.append(v)
            pos += 72
            if j != 20:
                d = self._bits(reader, pos, 24)
                if d is None:
                    return len(reader.dibits)
                sd_bits.append(d)
                pos += 24
        sd = np.concatenate(sd_bits)
        line = self._slow_data(sd, ctx)
        # AMBE 3600x2400 ECC (recovered, protocol/dstar/ambe2400.py):
        # FEC-validated 49-bit parameter frames + per-frame error counts
        from dsdneo_tpu_torch.protocol.dstar.ambe2400 import decode_dstar_ambe_ecc
        ambe = np.zeros((21, 49), dtype=np.uint8)
        errs = np.zeros(21, dtype=np.int32)
        for j, v in enumerate(voice):
            ambe[j], errs[j] = decode_dstar_ambe_ecc(v)
        ctx.emit(f"Sync: {hit.sync.name} VOICE  {line}", "dstar", hit.pos,
                 voice=np.stack(voice), ambe49=ambe, ambe_errs=errs)
        return pos

    def _slow_data(self, sd: np.ndarray, ctx: DecoderContext) -> str:
        sd = sd ^ np.tile(SD_SCRAMBLE, 20)
        sd = sd[::-1]
        sd_bytes = np.zeros(60, dtype=np.uint8)
        for i in range(60):
            v = 0
            for b in sd[i * 8:(i + 1) * 8]:
                v = (v << 1) | int(b)
            sd_bytes[59 - i] = v
        return slow_data_line(sd_bytes, ctx)

    def _header(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        """RF header: 660 coded bits → descramble (x⁷+x⁴+1 LFSR seed
        0x07) → deinterleave → rate-1/2 K=3 Viterbi → 41 octets
        (reference src/protocol/dstar/dstar_header.c,
        dstar_header_utils.c)."""
        bits = self._bits(reader, hit.end, 660)
        if bits is None:
            ctx.emit(f"Sync: {hit.sync.name} HEADER", "dstar", hit.pos)
            return hit.end
        b = bits ^ np.resize(_header_scramble(), 660)
        dei = np.zeros(660, dtype=np.uint8)
        k = 0
        for i in range(660):
            dei[k] = b[i]
            k += 24
            if k >= 672:
                k -= 671
            elif k >= 660:
                k -= 647
        info = _viterbi_k3(dei)
        hdr = np.zeros(41, dtype=np.uint8)
        for i in range(328):
            hdr[i // 8] |= int(info[i]) << (i % 8)
        line, _crc_ok, fields = header_line(hdr, ctx)
        ctx.emit(f"Sync: {hit.sync.name} HEADER  {line}", "dstar", hit.pos,
                 **fields)
        return hit.end + 660
