"""I/Q capture metadata, the sample reader and the writer (host, numpy).

The port's own copy of ``IqMetadata``, ``_decode_samples``,
``read_iq_capture`` and ``write_iq_capture`` of ``dsdneo_tpu/io/iq.py``.
The on-disk capture format is the reference's: a raw sample file
(``cu8`` unsigned 8-bit interleaved I/Q, ``cs16`` signed 16-bit, or
``cf32`` float32) and a ``.iq.json`` sidecar with the rates and their
provenance (include/dsd-neo/io/iq_replay.h:27-50, the sidecar fields
written by src/io/iq/iq_capture.c).  Samples come back as a numpy
complex64 array normalized to about [-1, 1], the same values from the
same bytes as the JAX package's reader; ``engine.decoder.decode_capture``
moves them to the decode's device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_SAMPLE_FORMATS = ("cu8", "cs16", "cf32")


@dataclass
class IqMetadata:
    """Sidecar metadata for an I/Q capture (``*.iq.json``)."""

    sample_format: str = "cu8"
    sample_rate_hz: int = 48000
    center_frequency_hz: int = 0
    capture_center_frequency_hz: int = 0
    ppm: int = 0
    tuner_gain_tenth_db: int = 0
    rtl_dsp_bw_khz: int = 48
    base_decimation: int = 1
    post_downsample: int = 1
    demod_rate_hz: int = 48000
    iq_order: str = "IQ"
    fs4_shift_enabled: bool = False
    offset_tuning_enabled: bool = False
    contains_retunes: bool = False
    data_file: str = ""
    data_bytes: int = 0
    source_backend: str = ""
    notes: str = ""
    extra: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, path: str) -> "IqMetadata":
        with open(path, "r") as f:
            raw = json.load(f)
        if raw.get("format") not in (None, "dsd-neo-iq"):
            raise ValueError(f"unrecognized iq metadata format: {raw.get('format')!r}")
        known = {k: raw[k] for k in cls.__dataclass_fields__ if k in raw}
        extra = {k: v for k, v in raw.items() if k not in cls.__dataclass_fields__}
        meta = cls(**known)
        meta.extra = extra
        if meta.sample_format not in _SAMPLE_FORMATS:
            raise ValueError(f"unsupported sample_format {meta.sample_format!r}")
        return meta

    def to_json_dict(self) -> dict:
        d = {
            "format": "dsd-neo-iq",
            "version": 1,
            "sample_format": self.sample_format,
            "iq_order": self.iq_order,
            "sample_rate_hz": self.sample_rate_hz,
            "center_frequency_hz": self.center_frequency_hz,
            "capture_center_frequency_hz": self.capture_center_frequency_hz,
            "ppm": self.ppm,
            "tuner_gain_tenth_db": self.tuner_gain_tenth_db,
            "rtl_dsp_bw_khz": self.rtl_dsp_bw_khz,
            "base_decimation": self.base_decimation,
            "post_downsample": self.post_downsample,
            "demod_rate_hz": self.demod_rate_hz,
            "offset_tuning_enabled": self.offset_tuning_enabled,
            "fs4_shift_enabled": self.fs4_shift_enabled,
            "contains_retunes": self.contains_retunes,
            "source_backend": self.source_backend,
            "data_file": self.data_file,
            "data_bytes": self.data_bytes,
            "notes": self.notes,
        }
        d.update(self.extra)
        return d


def _decode_samples(buf: bytes, fmt: str, iq_order: str) -> np.ndarray:
    if fmt == "cu8":
        arr = np.frombuffer(buf, dtype=np.uint8).astype(np.float32)
        arr = (arr - 127.5) * (1.0 / 127.5)
    elif fmt == "cs16":
        arr = np.frombuffer(buf, dtype="<i2").astype(np.float32) * (1.0 / 32768.0)
    elif fmt == "cf32":
        arr = np.frombuffer(buf, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported sample format {fmt!r}")
    n = arr.size // 2
    arr = arr[: 2 * n].reshape(n, 2)
    i, q = (0, 1) if iq_order.upper() == "IQ" else (1, 0)
    return (arr[:, i] + 1j * arr[:, q]).astype(np.complex64)


def read_iq_capture(path: str) -> tuple[IqMetadata, np.ndarray]:
    """Read a capture given either the sidecar ``.iq.json`` or the ``.iq`` file.

    Returns (metadata, complex64 samples normalized to ~[-1, 1]).
    """
    if path.endswith(".json"):
        meta_path = path
    elif os.path.exists(path + ".json"):
        meta_path = path + ".json"
    else:
        meta_path = None

    if meta_path is not None:
        meta = IqMetadata.from_json(meta_path)
        data_path = os.path.join(os.path.dirname(meta_path), meta.data_file) if meta.data_file else meta_path[: -len(".json")]
    else:
        meta = IqMetadata()
        data_path = path

    with open(data_path, "rb") as f:
        buf = f.read()
    samples = _decode_samples(buf, meta.sample_format, meta.iq_order)
    return meta, samples


def write_iq_capture(path: str, samples: np.ndarray, meta: Optional[IqMetadata] = None) -> None:
    """Write samples + sidecar in the interoperable capture format.

    ``path`` is the data file path (e.g. ``foo.iq``); the sidecar is written
    next to it as ``foo.iq.json``.
    """
    meta = meta or IqMetadata()
    fmt = meta.sample_format
    s = np.asarray(samples)
    inter = np.empty(2 * s.size, dtype=np.float32)
    inter[0::2] = s.real if meta.iq_order.upper() == "IQ" else s.imag
    inter[1::2] = s.imag if meta.iq_order.upper() == "IQ" else s.real
    if fmt == "cu8":
        raw = np.clip(np.round(inter * 127.5 + 127.5), 0, 255).astype(np.uint8).tobytes()
    elif fmt == "cs16":
        raw = np.clip(np.round(inter * 32768.0), -32768, 32767).astype("<i2").tobytes()
    elif fmt == "cf32":
        raw = inter.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported sample format {fmt!r}")
    with open(path, "wb") as f:
        f.write(raw)
    meta.data_file = os.path.basename(path)
    meta.data_bytes = len(raw)
    with open(path + ".json", "w") as f:
        json.dump(meta.to_json_dict(), f, indent=2)
        f.write("\n")
