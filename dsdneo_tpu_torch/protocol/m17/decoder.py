"""M17 (4800 symbols/s 4-level FSK) serial decoder: LSF, stream, BERT
and packet frames (host, numpy).

The port's own copy of ``dsdneo_tpu/protocol/m17/decoder.py``.  A frame
is an 8-symbol sync and 184 symbols (368 bits): derandomized (a fixed
368-bit sequence), de-interleaved by π(i) = (45i + 92i²) mod 368, then
by kind: the LSF depunctured by P1 and Viterbi-decoded (K=5, rate 1/2,
``fec.conv.decode_soft`` on the host) into 240 bits (DST 48, SRC 48,
TYPE 16, META 112, CRC-16 0x5935); a stream frame's 96-bit LICH
(4 × Golay(24,12) → a 40-bit LSF chunk and a 3-bit counter) and its
272-bit P2-punctured payload (FN and 128 Codec2 bits, decrypted by the
scrambler or AES-CTR, signed streams verified with ECDSA P-256); packet
frames (P3) carrying SMS; BERT frames (PRBS9).  Reference parity:
src/protocol/m17/m17.c, m17_algorithms.c, m17_tables.c; constants per
the M17 specification.  ``engine.m17batch`` reads the tables and CRC of
this module; the serial path (``engine.decoder``) registers
:class:`M17Decoder`.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import blockcodes, conv
from dsdneo_tpu_torch.protocol.base import (DecoderContext, DibitReader,
                                      ProtocolDecoder, register)
from dsdneo_tpu_torch.symbols.framesync import SyncHit

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

_P1 = np.array([1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,
                1,1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1,0,1,1],
               dtype=np.uint8)
_P2 = np.array([1,1,1,1,1,1,1,1,1,1,1,0], dtype=np.uint8)
_P3 = np.array([1,1,1,1,1,1,1,0], dtype=np.uint8)

BASE40 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-/."

DT_NAMES = {0: " Reserved", 1: " Data", 2: " Voice (3200bps)", 3: " Voice (1600bps)"}
ENC_NAMES = {1: " Scrambler", 2: " AES-CTR"}

# stream-payload encryption (reference m17.c:600-640, m17_algorithms.c:170-270)
_SCR_LFSR = {0: ((7, 5, 4, 3), 0xFF),
             1: ((15, 14, 12, 3), 0xFFFF),
             2: ((23, 22, 21, 16), 0xFFFFFF)}


def scrambler_keystream(subtype: int, state: int, n: int) -> tuple[np.ndarray, int]:
    """n M17 scrambler LFSR bits from ``state`` → (bits, new state)."""
    taps, mask = _SCR_LFSR.get(subtype, ((0,), 0))
    state &= mask
    out = np.zeros(n, dtype=np.uint8)
    if not mask or not state:
        return out, state
    for i in range(n):
        bit = 0
        for t in taps:
            bit ^= (state >> t)
        bit &= 1
        state = ((state << 1) | bit) & mask
        out[i] = bit
    return out, state


def aes_ctr_counter(meta14: bytes, fn: int) -> bytes:
    """AES-CTR initial counter: 14-byte META nonce + masked frame number
    (reference m17_aes_build_counter; EoT bit masked per gr-m17)."""
    fn &= 0x7FFF
    return bytes(meta14[:14]) + bytes([(fn >> 8) & 0x7F, fn & 0xFF])


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


def _depuncture(sym368: np.ndarray, pattern: np.ndarray, out_len: int
                ) -> tuple[np.ndarray, np.ndarray]:
    sym = np.zeros(out_len, dtype=np.float32)
    wt = np.zeros(out_len, dtype=np.float32)
    src = 0
    for i in range(out_len):
        if pattern[i % len(pattern)]:
            if src < len(sym368):
                sym[i] = sym368[src]
                wt[i] = 1.0
                src += 1
    return sym, wt


@register("m17")
class M17Decoder(ProtocolDecoder):
    protocol = "m17"

    def __init__(self):
        self.lsf_chunks = np.zeros((6, 40), dtype=np.uint8)
        self._last_lsf: np.ndarray | None = None   # full 240-bit LSF
        self._sid = 0x2950                          # session id for IP mode
        self.chunk_ok = [False] * 6
        self._last_lich_cnt: int | None = None
        self.polarity: bool | None = None
        self.pkt_chunks: dict[int, np.ndarray] = {}
        self.bert = {"lfsr": 1, "lock": 0, "locked": False,
                     "bits": 0, "errors": 0}
        self._dt: int | None = None        # data-type from a CRC-valid LSF
        self._enc = 0                      # 0 none / 1 scrambler / 2 AES
        self._enc_st = 0                   # subtype
        self._meta = b"\x00" * 14          # LSF META (AES nonce)
        self._c2 = None                    # lazy Codec2 instance
        self._scr_cache: tuple[int, int] | None = None  # (next_fn, lfsr)
        # META text assembly: expected/received block bitmaps + chars
        self._txt = {"expect": 0, "got": 0, "chars": {}}
        # signed-stream tracking (reference m17.c:381-935, m17_parse.c:
        # 53-105): TYPE bit 11 advertises an ECDSA P-256 signature over
        # a rolling 16-byte XOR/rotate digest of every raw payload,
        # delivered in the 4 frames FN 7FFC/7FFD/7FFE/FFFF.
        self._sig_adv = False
        self._sig_digest = bytearray(16)
        self._sig = bytearray(64)
        self._sig_mask = 0
        self._sig_done = False

    def _sig_reset(self) -> None:
        self._sig_digest = bytearray(16)
        self._sig = bytearray(64)
        self._sig_mask = 0
        self._sig_done = False

    def _payload_bits(self, reader: DibitReader, start: int) -> np.ndarray | None:
        if start + 184 > len(reader.dibits):
            return None
        dd = reader.dibits[start:start + 184].astype(np.uint8)
        if reader.invert:
            dd = dd ^ 2
        bits = np.empty(368, dtype=np.uint8)
        bits[0::2] = (dd >> 1) & 1
        bits[1::2] = dd & 1
        return bits

    def handle(self, reader: DibitReader, hit: SyncHit, ctx: DecoderContext) -> int:
        kind = hit.sync.kind
        # M17's STR sync is the symbol-wise complement of the LSF sync (and
        # PKT of BRT), so on an inverted channel an 8-symbol hit means its
        # complement kind.  Channel polarity is learned from a CRC-valid LSF.
        # Unknown polarity defaults to positive (reference assumes normal
        # polarity until -xz / inversion is established); pre_lsf keeps its
        # own inversion so an inverted LSF can still teach the polarity.
        want = self.polarity if self.polarity is not None else False
        if reader.invert != want and kind != "pre_lsf":
            kind = {"str": "lsf8", "lsf8": "str",
                    "pkt": "brt", "brt": "pkt"}.get(kind, kind)
            reader.invert = want
        polarity = "-" if reader.invert else "+"
        pos = hit.end
        if kind == "pre_lsf":
            return self._lsf(reader, hit, ctx, polarity)
        if kind == "lsf8":
            return self._lsf(reader, hit, ctx, polarity)
        if kind == "str":
            return self._stream(reader, hit, ctx, polarity)
        if kind == "brt":
            return self._bert(reader, hit, ctx, polarity)
        if kind == "pkt":
            return self._pkt(reader, hit, ctx, polarity)
        return pos

    def _decode_type1(self, bits368: np.ndarray, pattern: np.ndarray,
                      coded_len: int, nbits: int) -> np.ndarray:
        derand = bits368 ^ _SCRAMBLE[:368]
        deint = derand[_INTERLEAVE].astype(np.float32)
        sym, wt = _depuncture(deint, pattern, coded_len)
        return conv.decode_soft(sym, wt, nbits=nbits)

    def _lsf(self, reader, hit, ctx, polarity) -> int:
        bits = self._payload_bits(reader, hit.end)
        if bits is None:
            return len(reader.dibits)
        lsf = self._decode_type1(bits, _P1, 488, 240)
        if m17_crc16(_pack_bytes(lsf)) == 0:
            self.polarity = reader.invert
        return self._handle_lsf_bits(lsf, hit, ctx, polarity, "LSF")

    def _handle_lsf_bits(self, lsf: np.ndarray, hit, ctx, polarity, label) -> int:
        packed = _pack_bytes(lsf)
        if m17_crc16(packed) != 0:
            ctx.emit(f"Sync: {polarity}M17 {label}  CRC ERR", "m17", hit.pos)
            return hit.end + 184
        self._last_lsf = np.asarray(lsf, dtype=np.uint8).copy()
        dst = _bti(lsf[0:48])
        src = _bti(lsf[48:96])
        t = _bti(lsf[96:112])
        # type word fields are little-endian within the 16-bit value
        tw = t
        ps = tw & 1
        dt = (tw >> 1) & 3
        enc = (tw >> 3) & 3
        est = (tw >> 5) & 3
        cn = (tw >> 7) & 0xF
        if ps:
            self._dt, self._enc, self._enc_st = dt, enc, est
            self._meta = bytes(_pack_bytes(lsf[112:224]))
            self._scr_cache = None
            adv = bool((tw >> 11) & 1)
            if adv:
                # a standalone LSF starts the stream: fresh digest
                # (reference m17_apply_lsf_result m17.c:381-387)
                self._sig_reset()
            self._sig_adv = adv
        line = (f"Sync: {polarity}M17 {label} \n CAN: {cn}"
                f" DST: {decode_callsign(dst)} SRC: {decode_callsign(src)}"
                f"{DT_NAMES.get(dt, '') if ps else ' Packet'}"
                f"{ENC_NAMES.get(enc, '') if ps and enc else ''}")
        meta = _pack_bytes(lsf[112:224])
        if enc == 0 and int(meta.sum()):
            # ET=0: the encryption subtype selects the META protocol
            # (reference m17_null_meta_protocol_for_subtype: 0→text,
            # 1→GNSS 0x81, 2→extended callsign 0x82)
            if est == 0:
                line += (self._meta_text_block(meta)
                         or self._meta_decode(meta, ctx, allow_gnss=False))
            elif est == 1:
                line += self._meta_decode(meta, ctx)
            elif est == 2:
                line += self._meta_decode(meta, ctx)
            else:
                line += self._meta_decode(meta, ctx, allow_gnss=False)
        ctx.state.last_src = decode_callsign(src)
        ctx.emit(line, "m17", hit.pos, dst=dst, src=src, type=tw)
        return hit.end + 184

    @staticmethod
    def _meta_decode(meta, ctx, allow_gnss: bool = True) -> str:
        """LSF META field (14 octets, non-IV): GNSS v2 position
        (meta[0] 0x81/0x91, reference m17_parse.c
        m17_read_gnss_v2_fields), extended callsign (0x82), else raw
        hex.  Signed 24-bit lat/lon scale to ±90°/±180° over 2²³−1."""
        m = [int(b) for b in meta]
        if allow_gnss and m[0] in (0x81, 0x91):
            def s24(v):
                return v - (1 << 24) if v & 0x800000 else v
            lat_raw = (m[4] << 16) | (m[5] << 8) | m[6]
            lon_raw = (m[7] << 16) | (m[8] << 8) | m[9]
            lat = s24(lat_raw) * 90.0 / 8388607.0
            lon = s24(lon_raw) * 180.0 / 8388607.0
            alt = (m[10] << 8) | m[11]
            speed = (m[12] << 4) | (m[13] >> 4)
            validity = m[2] >> 4
            bearing = ((m[2] & 1) << 8) | m[3]
            out = (f"\n Meta GNSS Position Data"
                   f" Lat: {lat:.5f} Lon: {lon:.5f}")
            if validity & 0x2:
                out += f" Alt: {alt - 1500} m"
            if validity & 0x4:
                out += f" Speed: {speed / 4.0:.1f} km/h Bearing: {bearing}"
            ctx.state.m17_gps = (lat, lon)
            return out
        if m[0] == 0x82:
            txt = "".join(chr(b) if 0x19 < b < 0x7F else " "
                          for b in m[1:]).strip()
            return f"\n Meta Extended Callsign Data: {txt}"
        hexs = "".join(f"{b:02X}" for b in m)
        return f"\n META: {hexs}"

    _TXT_LEN = {0x1: 1, 0x3: 2, 0x7: 3, 0xF: 4}
    _TXT_SEG = {0x1: 0, 0x2: 1, 0x4: 2, 0x8: 3}

    def _meta_text_block(self, meta) -> str:
        """META text blocks: meta[0] packs a length bitmap (high
        nibble) + this block's bitmap (low nibble); 13 chars per block
        assemble across LSFs (reference m17_parse.c
        m17_meta_text_parse_block + assembler)."""
        m0 = int(meta[0])
        total = self._TXT_LEN.get(m0 >> 4)
        idx = self._TXT_SEG.get(m0 & 0xF)
        if total is None or idx is None or idx >= total:
            return ""
        expect = (1 << total) - 1
        if self._txt["expect"] != expect:
            self._txt = {"expect": expect, "got": 0, "chars": {}}
        self._txt["got"] |= 1 << idx
        # raw bytes preserved; decode once assembled (UTF-8 text keeps
        # its multi-byte chars — the reference copies blocks verbatim
        # and trims only trailing spaces)
        self._txt["chars"][idx] = bytes(int(b) for b in meta[1:14])
        if self._txt["got"] != expect:
            return f"\n Meta Text Block {idx + 1}/{total}"
        raw = b"".join(self._txt["chars"][i] for i in range(total))
        text = raw.decode("utf-8", errors="replace").rstrip(" \x00")
        self._txt = {"expect": 0, "got": 0, "chars": {}}
        return f"\n Meta Text Data: {text}"

    def _stream(self, reader, hit, ctx, polarity) -> int:
        bits = self._payload_bits(reader, hit.end)
        if bits is None:
            return len(reader.dibits)
        # de-randomize + de-interleave the whole 368-bit frame, then split
        deframe = (bits ^ _SCRAMBLE[:368])[_INTERLEAVE]
        lich_bits = deframe[:96]
        gol = blockcodes.golay_24_12()
        content = np.zeros(48, dtype=np.uint8)
        ok = True
        for blk in range(4):
            msg, errs = gol.decode(lich_bits[blk * 24:(blk + 1) * 24])
            if errs > 3:
                ok = False
            content[blk * 12:(blk + 1) * 12] = gol.codebook[msg][:12]
        line = f"Sync: {polarity}M17 STR "
        if not ok:
            ctx.emit(line + "LICH G24 ERR", "m17", hit.pos)
            return hit.end + 184
        cnt = _bti(content[40:43])
        if cnt > 5:
            ctx.emit(line + "LICH CNT ERR", "m17", hit.pos)
            return hit.end + 184
        line += f"LC: {cnt + 1}/6 "
        if (self._last_lich_cnt is not None
                and cnt != (self._last_lich_cnt + 1) % 6):
            # superframe discontinuity (new stream / dropped frames):
            # stale chunks from a previous transmission must not mix
            # into this LSF assembly
            self.chunk_ok = [False] * 6
        self._last_lich_cnt = cnt
        self.lsf_chunks[cnt] = content[:40]
        self.chunk_ok[cnt] = True
        detail = ""
        if cnt == 5 and all(self.chunk_ok):
            lsf = self.lsf_chunks.reshape(-1)
            packed = _pack_bytes(lsf)
            if m17_crc16(packed) == 0:
                self._last_lsf = np.asarray(lsf, dtype=np.uint8).copy()
                dst = _bti(lsf[0:48])
                src = _bti(lsf[48:96])
                tw = _bti(lsf[96:112])
                dt = (tw >> 1) & 3
                cn = (tw >> 7) & 0xF
                if tw & 1:
                    self._dt = dt
                    self._enc = (tw >> 3) & 3
                    self._enc_st = (tw >> 5) & 3
                    self._meta = bytes(_pack_bytes(lsf[112:224]))
                    adv = bool((tw >> 11) & 1)
                    if adv and not self._sig_adv:
                        # signature advertisement begins a fresh digest
                        # (reference m17_apply_lsf_result:381-387)
                        self._sig_reset()
                    self._sig_adv = adv
                detail = (f"\n CAN: {cn} DST: {decode_callsign(dst)}"
                          f" SRC: {decode_callsign(src)}{DT_NAMES.get(dt, '')}"
                          f"{ENC_NAMES.get(self._enc, '') if self._enc else ''}")
                ctx.state.last_src = decode_callsign(src)
            self.chunk_ok = [False] * 6
        # stream payload: FN(16) + voice(128) via P2
        payload = self._stream_payload(deframe[96:368])
        fields = {"lich_cnt": cnt}
        if payload is not None:
            fn = _bti(payload[0:16])
            line += f"FN: {fn & 0x7FFF:04X} "
            fields["fn"] = fn & 0x7FFF
            if fn & 0x8000:
                line += "EOT "
            sig_line = self._sig_track(fn, payload[16:144], ctx)
            if sig_line is not None:
                # signature frames carry r||s chunks, not voice
                # (reference M17collectSignaturePayload consumes them)
                ctx.emit(line + sig_line, "m17", hit.pos, **fields)
                return hit.end + 184
            sink = getattr(ctx, "m17_udp", None)
            if sink is not None and self._last_lsf is not None:
                from dsdneo_tpu_torch.protocol.m17.ip import pack_stream_frame
                sink.send(pack_stream_frame(
                    self._last_lsf, sid=self._sid, fn=fn & 0x7FFF,
                    eot=bool(fn & 0x8000), voice128=payload[16:144]))
            detail += self._voice(payload[16:144], fn & 0x7FFF, ctx)
        ctx.emit(line + detail, "m17", hit.pos, **fields)
        return hit.end + 184

    # -- signed streams -----------------------------------------------------

    def _sig_track(self, fn: int, v128: np.ndarray, ctx) -> str | None:
        """Signed-stream bookkeeping (reference m17.c:888-935 +
        m17_parse.c:64-105).  Returns a detail line when ``fn`` is one
        of the four signature frames (the caller then skips voice
        processing), else None after folding the raw payload into the
        rolling digest."""
        if not self._sig_adv or self._dt not in (2, 3):
            return None
        raw = bytes(_pack_bytes(v128))
        idx = {0x7FFC: 0, 0x7FFD: 1, 0x7FFE: 2, 0xFFFF: 3}.get(fn)
        if idx is None:
            if (fn & 0x7FFF) < 0x7FFC:
                # digest = rotate_left_bytes(digest XOR payload)
                d = bytes(a ^ b for a, b in zip(self._sig_digest, raw))
                self._sig_digest = bytearray(d[1:] + d[:1])
            return None
        bad_seq = idx > 0 and not (self._sig_mask & (1 << (idx - 1)))
        self._sig[idx * 16:(idx + 1) * 16] = raw
        self._sig_mask |= 1 << idx
        out = " SIG: " + "".join(f"[{b:02X}]" for b in raw)
        if idx == 3 and self._sig_mask == 0x0F and not self._sig_done:
            self._sig_done = True
            out += " COMPLETE;"
            pub = getattr(ctx.state, "m17_pubkey", None)
            if not pub:
                out += " NO PUBKEY;"
            else:
                from dsdneo_tpu_torch.crypto.ecdsa import p256_verify_digest
                ok = p256_verify_digest(bytes(self._sig_digest),
                                        bytes(pub), bytes(self._sig))
                out += " VERIFIED;" if ok else " VERIFY FAIL;"
                ctx.state.m17_sig_status = "valid" if ok else "invalid"
        elif bad_seq:
            out += " SEQUENCE ERR;"
        return out

    # -- stream voice -------------------------------------------------------

    def _decrypt(self, v128: np.ndarray, fn: int, ctx) -> np.ndarray | None:
        """Stream-payload decrypt (reference m17_decrypt_stream_payload,
        m17.c:600-640): scrambler keyed by -R seed, AES-CTR by META+FN."""
        if self._enc == 0:
            return v128
        s = ctx.state
        if self._enc == 1:
            seed = int(getattr(s, "m17_scrambler_key", 0) or 0)
            _, mask = _SCR_LFSR.get(self._enc_st, ((0,), 0))
            seed &= mask
            if not seed:
                return None
            cache = self._scr_cache
            if cache is not None and cache[0] == fn:
                state = cache[1]
            elif cache is not None and 0 < fn - cache[0] < fn:
                # dropped frames / late entry relative to the cached
                # position: advance the saved LFSR by the gap — O(gap)
                # instead of an O(fn·128) replay from the seed that
                # stalls a realtime decoder for seconds at high FN
                _, state = scrambler_keystream(
                    self._enc_st, cache[1], (fn - cache[0]) * 128)
            else:
                _, state = scrambler_keystream(self._enc_st, seed, fn * 128)
            ks, state = scrambler_keystream(self._enc_st, state, 128)
            self._scr_cache = (fn + 1, state)
            return v128 ^ ks
        if self._enc == 2:
            key = getattr(s, "m17_aes_key", None)
            if not key:
                return None
            from dsdneo_tpu_torch.crypto.keystream import aes_ctr_keystream
            ks = aes_ctr_keystream(bytes(key), aes_ctr_counter(self._meta, fn), 16)
            return v128 ^ np.unpackbits(ks)
        return None

    def _voice(self, v128: np.ndarray, fn: int, ctx) -> str:
        """Codec2 voice synthesis (reference M17processCodec2_3200/_1600,
        m17.c:755-835): 3200 = two 8-byte frames per payload, 1600 = one
        frame + 8 octets of arbitrary data. Encrypted payloads are only
        synthesized once decrypted (m17_can_emit_audio)."""
        plain = self._decrypt(v128, fn, ctx)
        if plain is None:
            return " *ENC*"
        dt = self._dt if self._dt in (2, 3) else 2
        v1 = np.packbits(plain[:64].astype(np.uint8))
        v2 = np.packbits(plain[64:128].astype(np.uint8))
        detail = ""
        if getattr(ctx, "verbose", 0) >= 1:
            h1 = " ".join(f"{b:02X}" for b in v1)
            h2 = " ".join(f"{b:02X}" for b in v2)
            if dt == 2:
                detail = f"\n CODEC2: {h1} (3200)\n CODEC2: {h2} (3200)"
            else:
                detail = f"\n CODEC2: {h1} (1600)\n A_DATA: {h2}"
        from dsdneo_tpu_torch.vocoder import codec2 as c2
        if c2.available():
            mode = c2.MODE_3200 if dt == 2 else c2.MODE_1600
            if self._c2 is None or self._c2.mode != mode:
                self._c2 = c2.Codec2(mode)
            pcm = (self._c2.decode(v1.tobytes()) if dt == 3 else
                   np.concatenate([self._c2.decode(v1.tobytes()),
                                   self._c2.decode(v2.tobytes())]))
            ctx.emit_audio(pcm.astype(np.float32) / 32768.0)
        if dt == 3 and v2.any():
            text = bytes(v2).split(b"\0")[0].decode("utf-8", "replace")
            if text and all(31 < ord(c) < 127 for c in text):
                detail += f"\n A_DATA: {text}"
        return detail

    def _stream_payload(self, bits272: np.ndarray) -> np.ndarray | None:
        sym, wt = _depuncture(bits272.astype(np.float32), _P2, 296)
        return conv.decode_soft(sym, wt, nbits=144)

    def _pkt(self, reader, hit, ctx, polarity) -> int:
        """Packet frame: 200 chunk bits + 6 metadata bits, P3-punctured
        (reference src/protocol/m17/m17_algorithms.c
        m17_packet_encode_type1_bits, m17_packet_parse_metadata_byte)."""
        bits = self._payload_bits(reader, hit.end)
        if bits is None:
            return len(reader.dibits)
        t1 = self._decode_type1(bits, _P3, 420, 206)
        mb = _bti(t1[200:206]) << 2
        eof = (mb >> 7) & 1
        value = (mb >> 2) & 0x1F
        line = f"Sync: {polarity}M17 PKT "
        if not eof:
            self.pkt_chunks[value] = t1[:200]
            ctx.emit(line + f"BLK: {value:02d}", "m17", hit.pos)
            return hit.end + 184
        if value == 0 or value > 25:
            ctx.emit(line + "META ERR", "m17", hit.pos)
            return hit.end + 184
        full = len(self.pkt_chunks)
        data = np.concatenate(
            [self.pkt_chunks[k] for k in sorted(self.pkt_chunks)] + [t1[:200]]
        ) if full else t1[:200]
        payload = _pack_bytes(data)[:full * 25 + value]
        self.pkt_chunks = {}
        if len(payload) < 3 or m17_crc16(payload) != 0:
            ctx.emit(line + "EOF CRC ERR", "m17", hit.pos)
            return hit.end + 184
        app = payload[:-2]
        detail = ""
        if app[0] == 0x05:            # SMS protocol identifier
            text = bytes(app[1:]).split(b"\0")[0].decode("utf-8", "replace")
            detail = f"\n SMS: {text}"
        ctx.emit(line + f"EOF ({len(app)} bytes){detail}", "m17", hit.pos,
                 payload=app)
        return hit.end + 184

    def _bert(self, reader, hit, ctx, polarity) -> int:
        """BERT frame: 197 PRBS9 bits, P2-punctured (reference
        src/protocol/m17/m17_algorithms.c m17_prbs9_rx_push_bit)."""
        bits = self._payload_bits(reader, hit.end)
        if bits is None:
            return len(reader.dibits)
        t1 = self._decode_type1(bits, _P2, 402, 197)
        st = self.bert
        for b in t1:
            b = int(b)
            if st["locked"]:
                s = st["lfsr"]
                exp = ((s >> 8) ^ (s >> 4)) & 1
                st["lfsr"] = ((s << 1) | exp) & 0x1FF
                st["bits"] += 1
                st["errors"] += exp != b
            else:
                s = st["lfsr"]
                exp = ((s >> 8) ^ (s >> 4)) & 1
                st["lock"] = st["lock"] + 1 if exp == b else 0
                st["lfsr"] = ((s << 1) | b) & 0x1FF
                if st["lock"] >= 18:
                    st["locked"] = True
        tag = "LOCK" if st["locked"] else "SYNCING"
        ctx.emit(f"Sync: {polarity}M17 BRT BERT: {tag}"
                 f" bits:{st['bits']} errors:{st['errors']}",
                 "m17", hit.pos)
        return hit.end + 184
