"""ProVoice TX-side synthesis (test/bench material).

The reference ships no ProVoice fixture (docs/testing.md:63-66 names it
a known gap), so working-channel follow tests need synthesized frames:
this module builds the 736-bit ProVoice voice superframe the decoder
walks (protocol/provoice/decoder.py handle):

  [N64 initial][LID 16][N64 secondary]
  [IMBE-7100 frame pair, interleaved][2 pad][BF 16]
  [IMBE-7100 frame pair, interleaved][2 pad]

The interleave schedule is derived ONCE from the same walk the decoder
uses (pair_bit_schedule), so encoder and decoder cannot drift.

The port's own copy of ``dsdneo_tpu/protocol/provoice/encode.py``
(numpy only).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from dsdneo_tpu_torch.protocol.provoice.decoder import _W, _X


@lru_cache(maxsize=1)
def pair_bit_schedule() -> tuple:
    """Stream-order schedule of one interleaved IMBE-7100 frame pair:
    a tuple of ('1'|'2', w, x) per payload bit and ('pad', 0, 0) for
    the mid-pair 2-bit stream pad — the exact walk of
    ProVoiceDecoder._load_pair."""
    sched = []
    k = [0]

    def seg(tag, n, off=0):
        base = k[0] + off
        for i in range(n):
            sched.append((tag, _W[base + i], _X[base + i]))

    for _ in range(11):
        seg("1", 6); seg("2", 6); k[0] += 6
    seg("1", 6); seg("2", 4)
    sched.append(("pad", 0, 0)); sched.append(("pad", 0, 0))
    seg("2", 2, off=4); k[0] += 6
    for _ in range(3):
        seg("1", 6); seg("2", 6); k[0] += 6
    seg("1", 5); seg("2", 5); k[0] += 5
    for _ in range(7):
        seg("1", 6); seg("2", 6); k[0] += 6
    seg("1", 5); seg("2", 5); k[0] += 5
    return tuple(sched)


def interleave_pair(f1: np.ndarray, f2: np.ndarray) -> np.ndarray:
    """[7, 24] code-vector frames → stream bits (inverse of
    ProVoiceDecoder._load_pair)."""
    sched = pair_bit_schedule()
    out = np.zeros(len(sched), dtype=np.uint8)
    for i, (tag, w, x) in enumerate(sched):
        if tag == "1":
            out[i] = f1[w, x]
        elif tag == "2":
            out[i] = f2[w, x]
    return out


def _int_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)],
                    dtype=np.uint8)


def encode_provoice_superframe(frames: np.ndarray, lid: int = 0x1234,
                               bf: int = 0xABCD, n64a: int = 0,
                               n64b: int = 0) -> np.ndarray:
    """[4, 7, 24] IMBE-7100 code-vector frames → the 736 stream bits
    after the sync (decoder handle's consumption)."""
    assert frames.shape == (4, 7, 24)
    pad2 = np.zeros(2, dtype=np.uint8)      # post-pair stream pads
    parts = [_int_bits(n64a, 64), _int_bits(lid, 16), _int_bits(n64b, 64),
             interleave_pair(frames[0], frames[1]), pad2,
             _int_bits(bf, 16),
             interleave_pair(frames[2], frames[3]), pad2]
    bits = np.concatenate(parts)
    assert bits.size == 736, bits.size
    return bits


def provoice_stream_dibits(frames: np.ndarray, lid: int = 0x1234,
                           bf: int = 0xABCD, lead: int = 60,
                           tail: int = 60) -> np.ndarray:
    """Full dibit stream: leader + ProVoice sync + superframe bits as
    2-level dibits (bit 1 → dibit 3, bit 0 → dibit 1 — the sign-bit
    convention the decoder reads back)."""
    from dsdneo_tpu_torch.symbols import framesync
    sync = next(d for d in framesync.SYNC_DEFS if d.name == "+ProVoice")
    sync_d = np.array([int(c) for c in sync.pattern], dtype=np.uint8)
    bits = encode_provoice_superframe(frames, lid=lid, bf=bf)
    body = np.where(bits > 0, 3, 1).astype(np.uint8)
    # pseudorandom leader/tail: an alternating 1,3 dotting sequence
    # correlates with the EDACS sync and steals the hunt
    rng = np.random.default_rng(0x9600)
    lead_d = rng.choice(np.array([1, 3], np.uint8), lead)
    tail_d = rng.choice(np.array([1, 3], np.uint8), tail)
    return np.concatenate([lead_d, sync_d, body, tail_d])
