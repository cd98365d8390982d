"""MBE voice-frame data files (.imb / .amb).

Reference-compatible format (src/core/file/dsd_file.c
saveImbe4400Data/saveAmbe2450Data, openMbeInFile): a 4-byte cookie
(".imb" for IMBE 88-bit frames, ".amb" for AMBE+2 49-bit) followed by
per-frame records:

  .imb:  [err byte][11 bytes = 88 frame bits MSB-first]
  .amb:  [err byte][6 bytes = bits 0..47][1 byte = raw bit 48]

The port's own copy of ``dsdneo_tpu/io/mbe_files.py`` (host Python,
numpy); playback synthesizes on the caller's device.
"""

from __future__ import annotations

import numpy as np

COOKIES = {"imb": b".imb", "amb": b".amb"}


class MbeFileWriter:
    def __init__(self, path: str):
        kind = "amb" if path.endswith(".amb") else "imb"
        self.kind = kind
        self._f = open(path, "wb")
        self._f.write(COOKIES[kind])
        self.frames = 0

    def write(self, bits: np.ndarray, errs: int = 0) -> None:
        b = np.asarray(bits, dtype=np.uint8)
        self._f.write(bytes([errs & 0xFF]))
        if self.kind == "imb":
            self._f.write(np.packbits(b[:88]).tobytes())
        else:
            self._f.write(np.packbits(b[:48]).tobytes())
            self._f.write(bytes([int(b[48]) & 1]))
        self.frames += 1

    def close(self) -> None:
        self._f.close()


def read_mbe_file(path: str) -> tuple[str, list[tuple[int, np.ndarray]]]:
    """→ (kind, [(errs, frame bits)]) — kind 'imb' (88 bits) or 'amb'
    (49 bits)."""
    data = open(path, "rb").read()
    cookie = data[:4]
    if cookie == b".imb":
        kind, nbits, rec = "imb", 88, 12
    elif cookie == b".amb":
        kind, nbits, rec = "amb", 49, 8
    else:
        raise ValueError(f"unrecognized MBE cookie {cookie!r}")
    frames = []
    at = 4
    while at + rec <= len(data):
        errs = data[at]
        if kind == "imb":
            bits = np.unpackbits(
                np.frombuffer(data[at + 1:at + 12], dtype=np.uint8))[:88]
        else:
            bits = np.zeros(49, dtype=np.uint8)
            bits[:48] = np.unpackbits(
                np.frombuffer(data[at + 1:at + 7], dtype=np.uint8))
            bits[48] = data[at + 7] & 1
        frames.append((int(errs), bits))
        at += rec
    return kind, frames


def synthesize_mbe_file(path: str, device=None) -> np.ndarray:
    """Decode an .imb/.amb file to 8 kHz PCM (the reference's MBE file
    playback path, dsd_file.c openMbeInFile + playMbeFiles), synthesized
    on ``device`` (the card when none is given)."""
    from dsdneo_tpu_torch.vocoder.mbe import decode_ambe_2450, decode_imbe_4400
    from dsdneo_tpu_torch.vocoder.synth import synthesize_frames
    kind, frames = read_mbe_file(path)
    params = []
    prev = None
    for errs, bits in frames:
        if kind == "imb":
            prev = decode_imbe_4400(bits, prev=prev)
            params.append(prev)
        else:
            params.append(decode_ambe_2450(bits))
    return synthesize_frames(params, device)
