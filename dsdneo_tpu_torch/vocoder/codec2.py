"""Codec2 voice coding for M17 through the system's libcodec2 (host).

The port's own copy of ``dsdneo_tpu/vocoder/codec2.py``: an optional
external library, loaded with ``ctypes`` when present, never built
here.  M17 stream voice decodes with ``codec2_3200`` (two 64-bit frames
per 40 ms payload) or ``codec2_1600`` (one 64-bit frame and 64 bits of
data).  Voice frames are 8 bytes at 25-50 frames per second and channel,
so this stays a host call in both packages, not a device path;
``available()`` is False when the library is absent and the M17
pipeline then synthesizes nothing.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np

MODE_3200 = 0
MODE_1600 = 2

_SAMPLES = {MODE_3200: 160, MODE_1600: 320}

_CANDIDATES = (
    "libcodec2.so.1.0",
    "libcodec2.so.1",
    "libcodec2.so",
)


@lru_cache(maxsize=1)
def _lib():
    for name in _CANDIDATES:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        found = ctypes.util.find_library("codec2")
        if not found:
            return None
        try:
            lib = ctypes.CDLL(found)
        except OSError:
            return None
    lib.codec2_create.restype = ctypes.c_void_p
    lib.codec2_create.argtypes = [ctypes.c_int]
    lib.codec2_destroy.argtypes = [ctypes.c_void_p]
    lib.codec2_decode.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_short),
                                  ctypes.POINTER(ctypes.c_ubyte)]
    lib.codec2_encode.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_ubyte),
                                  ctypes.POINTER(ctypes.c_short)]
    lib.codec2_samples_per_frame.restype = ctypes.c_int
    lib.codec2_samples_per_frame.argtypes = [ctypes.c_void_p]
    lib.codec2_bits_per_frame.restype = ctypes.c_int
    lib.codec2_bits_per_frame.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _lib() is not None


class Codec2:
    """One Codec2 codec instance (decoder state carries across frames,
    matching the reference's per-session ``state->codec2_3200/1600``)."""

    def __init__(self, mode: int = MODE_3200):
        lib = _lib()
        if lib is None:
            raise RuntimeError("libcodec2 not available")
        self._lib = lib
        self.mode = mode
        self._c2 = lib.codec2_create(mode)
        if not self._c2:
            raise RuntimeError(f"codec2_create({mode}) failed")
        self.samples_per_frame = int(lib.codec2_samples_per_frame(self._c2))
        self.bits_per_frame = int(lib.codec2_bits_per_frame(self._c2))

    def __del__(self):
        c2 = getattr(self, "_c2", None)
        if c2:
            self._lib.codec2_destroy(c2)
            self._c2 = None

    def decode(self, frame: bytes | np.ndarray) -> np.ndarray:
        """8-byte codec2 frame → int16 PCM [samples_per_frame] @ 8 kHz."""
        buf = (ctypes.c_ubyte * 8)(*bytes(frame)[:8])
        pcm = (ctypes.c_short * self.samples_per_frame)()
        self._lib.codec2_decode(self._c2, pcm, buf)
        return np.frombuffer(pcm, dtype=np.int16).copy()

    def decode_bits(self, bits64: np.ndarray) -> np.ndarray:
        return self.decode(np.packbits(bits64.astype(np.uint8)).tobytes())

    def encode(self, pcm: np.ndarray) -> bytes:
        """int16 PCM [samples_per_frame] → 8-byte codec2 frame."""
        pcm = np.asarray(pcm, dtype=np.int16)
        if pcm.shape[0] != self.samples_per_frame:
            raise ValueError(f"need {self.samples_per_frame} samples")
        sp = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        buf = (ctypes.c_ubyte * ((self.bits_per_frame + 7) // 8))()
        self._lib.codec2_encode(self._c2, buf, sp)
        return bytes(buf)

    def encode_bits(self, pcm: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(np.frombuffer(self.encode(pcm), dtype=np.uint8))
        return bits[:self.bits_per_frame]
