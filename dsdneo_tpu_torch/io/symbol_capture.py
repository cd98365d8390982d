"""Symbol capture files: legacy dibit ``.bin`` and soft ``DSDNSYM2``.

Interoperable with the reference's formats (include/dsd-neo/core/
dibit.h:29-37): legacy = one byte per dibit; DSDNSYM2 = 16-byte header
(magic ‖ version ‖ flags) + 10-byte records
(dibit u8, reliability u8, llr[2] i16 ×2, reserved) — the soft record
layout observed from src/core/frames/dsd_dibit.c capture writer.

The port's own copy of ``dsdneo_tpu/io/symbol_capture.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

SOFT_MAGIC = b"DSDNSYM2"
SOFT_HEADER = 16
SOFT_RECORD = 10


@dataclass
class SymbolCapture:
    dibits: np.ndarray                  # [N] uint8
    reliability: np.ndarray | None = None   # [N] uint8
    llr: np.ndarray | None = None           # [N, 2] int16


def read_symbol_capture(path: str) -> SymbolCapture:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] == SOFT_MAGIC:
        body = np.frombuffer(raw[SOFT_HEADER:], dtype=np.uint8)
        n = len(body) // SOFT_RECORD
        rec = body[: n * SOFT_RECORD].reshape(n, SOFT_RECORD)
        dibits = rec[:, 0].copy()
        reliability = rec[:, 1].copy()
        llr = rec[:, 2:6].copy().view("<i2").reshape(n, 2)
        return SymbolCapture(dibits, reliability, llr)
    return SymbolCapture(np.frombuffer(raw, dtype=np.uint8).copy() & 3)


def write_symbol_capture(path: str, cap: SymbolCapture,
                         soft: bool = True) -> None:
    if not soft:
        with open(path, "wb") as f:
            f.write(cap.dibits.astype(np.uint8).tobytes())
        return
    n = cap.dibits.shape[0]
    rec = np.zeros((n, SOFT_RECORD), dtype=np.uint8)
    rec[:, 0] = cap.dibits & 3
    rel = (cap.reliability if cap.reliability is not None
           else np.full(n, 255, dtype=np.uint8))
    rec[:, 1] = rel
    if cap.llr is not None:
        rec[:, 2:6] = cap.llr.astype("<i2").view(np.uint8).reshape(n, 4)
    else:
        # derive LLRs from the hard dibit + reliability
        sign = np.where((cap.dibits >> 1) & 1, -1, 1).astype(np.int32)
        mag = rel.astype(np.int32)
        llr0 = (-sign * mag).astype("<i2")
        llr1 = np.where(cap.dibits & 1, mag, -mag).astype("<i2")
        rec[:, 2:4] = llr0.view(np.uint8).reshape(n, 2)
        rec[:, 4:6] = llr1.view(np.uint8).reshape(n, 2)
    with open(path, "wb") as f:
        f.write(SOFT_MAGIC + struct.pack("<BB6x", 2, 10))
        f.write(rec.tobytes())


def soft_from_norm(dibits: np.ndarray, norm: np.ndarray) -> SymbolCapture:
    """Build a soft capture from the pipeline's normalized symbols."""
    lv = np.array([1.0, 3.0, -1.0, -3.0], dtype=np.float32)
    dist = np.abs(norm - lv[dibits])
    rel = np.clip(255 * (1.0 - dist), 0, 255).astype(np.uint8)
    return SymbolCapture(dibits.astype(np.uint8), rel)
