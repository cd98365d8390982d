"""M17 encoders: LSF, stream, BERT and packet frame generation.

The reference's only TX paths (src/protocol/m17/m17.c stream/packet/
BERT encoders, m17.h:26-28).  Produces dibit streams in the shared
±1/±3 alphabet (and optionally baseband audio-rate symbols) that this
package's own decoder — and the reference — can decode; loopback tests
assert round trips through the full receive chain.

The port's own copy of ``dsdneo_tpu/protocol/m17/encoder.py`` (host
Python, numpy), unchanged in its logic.
"""

from __future__ import annotations

import numpy as np

from dsdneo_tpu_torch.fec import conv
from dsdneo_tpu_torch.protocol.m17.decoder import (_INTERLEAVE, _P1, _P2, _P3,
                                             _SCRAMBLE, BASE40, m17_crc16,
                                             _pack_bytes)
from dsdneo_tpu_torch.fec.blockcodes import golay_24_12

# Preamble + LSF sync, 16 dibits, matching the receive pattern
# (reference include/dsd-neo/core/sync_patterns.h:23 M17_PRE_LSF
# "3131313133331131"; '1' = +3 = dibit 1, '3' = −3 = dibit 3).
SYNC_LSF = [3, 1, 3, 1, 3, 1, 3, 1, 3, 3, 3, 3, 1, 1, 3, 1]
SYNC_STR = [3 if c == "3" else 1 for c in "33331131"]
SYNC_PKT = [3 if c == "3" else 1 for c in "13113333"]
SYNC_BRT = [3 if c == "3" else 1 for c in "31331111"]
SYNC_EOT = [3 if c == "3" else 1 for c in "11111131"]


def _eot_and_dead_air(n_eot: int = 6, n_dead: int = 96) -> np.ndarray:
    """End-of-transmission marker + dead-air symbols (reference
    src/protocol/m17/m17.c m17_send_dead_air_frames)."""
    return np.concatenate([np.tile(np.array(SYNC_EOT, dtype=np.uint8), n_eot),
                           np.zeros(n_dead, dtype=np.uint8)])


def encode_callsign(cs: str) -> int:
    if cs.upper() == "BROADCAST":
        return 0xFFFFFFFFFFFF
    v = 0
    for ch in reversed(cs.upper()):
        idx = BASE40.find(ch)
        if idx < 0:
            idx = 0
        v = v * 40 + idx
    return v


def _bits_of_int(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], dtype=np.uint8)


def build_lsf(dst: str, src: str, can: int = 0, stream: bool = True,
              dt: int = 2, meta: bytes = b"", enc: int = 0,
              enc_st: int = 0, signed_stream: bool = False) -> np.ndarray:
    """→ 240 LSF bits (DST, SRC, TYPE, META, CRC16)."""
    lsf = np.zeros(240, dtype=np.uint8)
    lsf[0:48] = _bits_of_int(encode_callsign(dst), 48)
    lsf[48:96] = _bits_of_int(encode_callsign(src), 48)
    tw = ((1 if stream else 0) | (dt << 1) | ((enc & 3) << 3)
          | ((enc_st & 3) << 5) | ((can & 0xF) << 7)
          | ((1 if signed_stream else 0) << 11))
    lsf[96:112] = _bits_of_int(tw, 16)
    mb = (meta + bytes(14))[:14]
    for i, byte in enumerate(mb):
        lsf[112 + 8 * i:120 + 8 * i] = _bits_of_int(byte, 8)
    crc = m17_crc16(_pack_bytes(lsf[:224]))
    lsf[224:240] = _bits_of_int(crc, 16)
    return lsf


def _frame_encode(bits368_type4: np.ndarray) -> np.ndarray:
    """type-4 (368 coded bits) → randomized+interleaved on-air bits."""
    out = np.zeros(368, dtype=np.uint8)
    out[_INTERLEAVE] = bits368_type4      # interleave (inverse of decode)
    return out ^ _SCRAMBLE[:368]


def _puncture(coded: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    keep = np.array([pattern[i % len(pattern)] for i in range(len(coded))],
                    dtype=bool)
    return coded[keep]


def encode_lsf_frame(lsf240: np.ndarray) -> np.ndarray:
    """LSF → 184 on-air dibit values (after the 16-symbol sync)."""
    coded = conv.encode(lsf240)           # 488 bits
    type4 = _puncture(coded, _P1)         # 368
    onair = _frame_encode(type4)
    return _bits_to_dibits(onair)


def encode_stream_frame(lsf240: np.ndarray, chunk_idx: int, fn: int,
                        voice128: np.ndarray, eot: bool = False) -> np.ndarray:
    """One stream frame: LICH chunk + FN/payload → 184 dibits."""
    g24 = golay_24_12()
    content = np.zeros(48, dtype=np.uint8)
    content[:40] = lsf240[40 * chunk_idx:40 * (chunk_idx + 1)]
    content[40:43] = _bits_of_int(chunk_idx, 3)
    lich = np.zeros(96, dtype=np.uint8)
    for blk in range(4):
        msg = 0
        for b in content[12 * blk:12 * (blk + 1)]:
            msg = (msg << 1) | int(b)
        lich[24 * blk:24 * (blk + 1)] = g24.codebook[msg]

    payload = np.zeros(144, dtype=np.uint8)
    payload[0:16] = _bits_of_int((0x8000 if eot else 0) | (fn & 0x7FFF), 16)
    payload[16:144] = voice128
    coded = conv.encode(payload)          # 296
    type4 = _puncture(coded, _P2)         # 272
    onair = _frame_encode(np.concatenate([lich, type4]))
    return _bits_to_dibits(onair)


def _bits_to_dibits(bits: np.ndarray) -> np.ndarray:
    d = (bits[0::2].astype(np.uint8) << 1) | bits[1::2].astype(np.uint8)
    return d


def encode_stream_transmission(dst: str, src: str, voice_frames: np.ndarray,
                               can: int = 0, dt: int = 2, enc: int = 0,
                               enc_st: int = 0, meta: bytes = b"",
                               scrambler_seed: int = 0,
                               aes_key: bytes | None = None,
                               sign_key: int = 0,
                               sign_k: int = 0) -> np.ndarray:
    """Full TX: preamble + LSF frame + stream frames → dibit array.

    voice_frames: [F, 128] codec2 bit payloads (zeros for silence).
    With enc=1/2 the payloads are scrambler/AES-CTR encrypted exactly
    as the reference TX does (m17.c m17_str_encode → encrypt before
    conv-encoding), so the RX decrypt path round-trips.  With a
    ``sign_key`` (P-256 scalar) the stream is signed: TYPE bit 11 is
    set, the rolling XOR/rotate digest is taken over every transmitted
    payload, and the 64-byte r||s signature rides the four tail frames
    FN 7FFC/7FFD/7FFE/FFFF (reference m17.c:888-935 RX contract)."""
    lsf = build_lsf(dst, src, can=can, stream=True, dt=dt, meta=meta,
                    enc=enc, enc_st=enc_st, signed_stream=bool(sign_key))
    out = [np.array([3, 1] * 24, dtype=np.uint8)]        # preamble dotting
    out.append(np.array(SYNC_LSF, dtype=np.uint8))
    out.append(encode_lsf_frame(lsf))
    fcount = voice_frames.shape[0]
    digest = bytearray(16)
    for i in range(fcount):
        v = voice_frames[i].astype(np.uint8)
        if enc == 1 and scrambler_seed:
            from dsdneo_tpu_torch.protocol.m17.decoder import scrambler_keystream
            _, st = scrambler_keystream(enc_st, scrambler_seed, i * 128)
            ks, _ = scrambler_keystream(enc_st, st, 128)
            v = v ^ ks
        elif enc == 2 and aes_key:
            from dsdneo_tpu_torch.crypto.keystream import aes_ctr_keystream
            from dsdneo_tpu_torch.protocol.m17.decoder import aes_ctr_counter
            ks = aes_ctr_keystream(bytes(aes_key),
                                   aes_ctr_counter((meta + bytes(14))[:14], i),
                                   16)
            v = v ^ np.unpackbits(ks)
        out.append(np.array(SYNC_STR, dtype=np.uint8))
        out.append(encode_stream_frame(lsf, i % 6, i, v,
                                       eot=(not sign_key
                                            and i == fcount - 1)))
        if sign_key:
            raw = np.packbits(v).tobytes()
            d = bytes(a ^ b for a, b in zip(digest, raw))
            digest = bytearray(d[1:] + d[:1])
    if sign_key:
        from dsdneo_tpu_torch.crypto.ecdsa import p256_sign_digest
        sig = p256_sign_digest(bytes(digest), sign_key,
                               sign_k or 0x1D0C5F2A9B3E7481)
        for j, fn in enumerate((0x7FFC, 0x7FFD, 0x7FFE, 0x7FFF)):
            chunk = np.unpackbits(
                np.frombuffer(sig[j * 16:(j + 1) * 16], dtype=np.uint8))
            out.append(np.array(SYNC_STR, dtype=np.uint8))
            out.append(encode_stream_frame(lsf, (fcount + j) % 6, fn,
                                           chunk.astype(np.uint8),
                                           eot=(j == 3)))
    out.append(_eot_and_dead_air())
    return np.concatenate(out)


def build_sms_packet(text: str) -> np.ndarray:
    """SMS packet payload: 0x05 + UTF-8 text + NUL + CRC16 (reference
    src/protocol/m17/m17_algorithms.c m17_packet_prepare_sms_payload)."""
    body = bytes([0x05]) + text.encode("utf-8")[:821] + b"\0"
    crc = m17_crc16(np.frombuffer(body, dtype=np.uint8))
    return np.frombuffer(body + bytes([crc >> 8, crc & 0xFF]), dtype=np.uint8)


def encode_packet_frame(chunk_bits200: np.ndarray, eof: bool,
                        value: int) -> np.ndarray:
    """One packet frame: chunk(200) + metadata(6) → P3 puncture → 184 dibits.

    value = block counter (non-EOF) or last-frame byte count (EOF)."""
    mb = ((1 if eof else 0) << 7) | ((value & 0x1F) << 2)
    type1 = np.concatenate([chunk_bits200.astype(np.uint8),
                            _bits_of_int(mb >> 2, 6)])
    coded = conv.encode(type1)            # 420
    type4 = _puncture(coded, _P3)         # 368
    return _bits_to_dibits(_frame_encode(type4))


def encode_packet_transmission(dst: str, src: str, text: str,
                               can: int = 0) -> np.ndarray:
    """Full packet TX: preamble + LSF (P/S=0, DT=data) + packet frames."""
    lsf = build_lsf(dst, src, can=can, stream=False, dt=1)
    out = [np.array([3, 1] * 24, dtype=np.uint8),
           np.array(SYNC_LSF, dtype=np.uint8),
           encode_lsf_frame(lsf)]
    payload = build_sms_packet(text)
    nframes = max(1, -(-len(payload) // 25))
    last = len(payload) - 25 * (nframes - 1)
    bits = np.zeros(nframes * 200, dtype=np.uint8)
    for i, byte in enumerate(payload):
        bits[8 * i:8 * (i + 1)] = _bits_of_int(int(byte), 8)
    for i in range(nframes):
        eof = i == nframes - 1
        out.append(np.array(SYNC_PKT, dtype=np.uint8))
        out.append(encode_packet_frame(bits[200 * i:200 * (i + 1)],
                                       eof, last if eof else i))
    out.append(_eot_and_dead_air())
    return np.concatenate(out)


def prbs9_bits(n: int, state: int = 1) -> tuple[np.ndarray, int]:
    """M17 BERT PRBS9: feedback (s>>8)^(s>>4) (reference
    src/protocol/m17/m17_algorithms.c m17_prbs9_next_bit)."""
    out = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        bit = ((state >> 8) ^ (state >> 4)) & 1
        state = ((state << 1) | bit) & 0x1FF
        out[i] = bit
    return out, state


def encode_bert_transmission(n_frames: int, state: int = 1) -> np.ndarray:
    """BERT TX: per frame 197 PRBS9 bits → conv → P2 puncture → 184 dibits."""
    out = [np.array([3, 1] * 24, dtype=np.uint8)]
    for _ in range(n_frames):
        bits197, state = prbs9_bits(197, state)
        # 402 coded bits → 369 kept; the payload holds 368 (reference
        # m17_puncture_bits stops at M17_PAYLOAD_BITS)
        type4 = _puncture(conv.encode(bits197), _P2)[:368]
        out.append(np.array(SYNC_BRT, dtype=np.uint8))
        out.append(_bits_to_dibits(_frame_encode(type4)))
    out.append(_eot_and_dead_air())
    return np.concatenate(out)


def dibits_to_baseband(dibits: np.ndarray, sps: int = 10,
                       dev: float = 0.25) -> np.ndarray:
    """Dibits → complex 4FSK baseband (for replay-file generation):
    instantaneous frequency = level/3 · dev · Nyquist."""
    lv = np.array([1.0, 3.0, -1.0, -3.0])[dibits] / 3.0
    inst = np.repeat(lv, sps) * dev          # cycles per sample × 2
    phase = np.pi * np.cumsum(inst)
    return np.exp(1j * phase).astype(np.complex64)
