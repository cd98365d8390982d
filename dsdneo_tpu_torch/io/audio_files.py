"""WAV/PCM audio file output (per-call and raw sinks).

Reference parity: src/core/file/dsd_file.c (per-call WAV writer).

The port's own copy of ``dsdneo_tpu/io/audio_files.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def write_wav(path: str, pcm: np.ndarray, rate: int = 8000) -> None:
    """Write mono float [-1,1] or int16 PCM to a WAV file."""
    x = np.asarray(pcm)
    if x.dtype != np.int16:
        x = np.clip(x, -1.0, 1.0)
        x = (x * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(x.tobytes())


def read_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        rate = w.getframerate()
        raw = w.readframes(n)
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        if w.getnchannels() > 1:
            x = x.reshape(-1, w.getnchannels()).mean(axis=1)
    return x, rate
