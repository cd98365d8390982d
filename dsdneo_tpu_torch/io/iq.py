"""I/Q capture metadata, the sample reader and writers (host, numpy).

The port's own copy of ``dsdneo_tpu/io/iq.py``: ``IqMetadata``,
``read_iq_capture``, ``write_iq_capture``, and the live path's streaming
``IqCaptureWriter`` with its retune event journal (``IqEvent``,
``read_iq_events``, ``replay_segments``).
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


@dataclass
class IqEvent:
    """Capture event journal entry (reference io/iq_types.h dsd_iq_event:
    retune/mute/reset markers stamped with the byte offset where they
    occurred, so replay can reproduce tuning history)."""
    kind: str                       # "retune" | "mute" | "reset"
    byte_offset: int = 0
    duration_bytes: int = 0
    center_frequency_hz: int = 0
    capture_center_frequency_hz: int = 0
    sample_rate_hz: int = 0
    reason: str = ""


_BYTES_PER_SAMPLE = {"cu8": 2, "cs16": 4, "cf32": 8}


class IqCaptureWriter:
    """Streaming capture writer with a retune/mute/reset event journal —
    the rebuild's analog of src/io/iq/iq_capture.c dsd_iq_capture_open/
    submit/record_event/close (checkpointable acquisition: the journal
    lets replay re-create the tuning timeline)."""

    def __init__(self, path: str, meta: Optional[IqMetadata] = None,
                 max_bytes: int = 0):
        self.meta = meta or IqMetadata()
        self.path = path
        self.max_bytes = max_bytes
        self.events: list[IqEvent] = []
        self.accepted_bytes = 0
        self.drops = 0
        self._f = open(path, "wb")
        self._closed = False
        self._capped = False

    def submit(self, samples: np.ndarray) -> int:
        """Append complex samples; returns bytes written (0 once the
        max-bytes cap is reached — further samples count as drops)."""
        fmt = self.meta.sample_format
        s = np.asarray(samples)
        inter = np.empty(2 * s.size, dtype=np.float32)
        if getattr(self.meta, "iq_order", "IQ") == "QI":
            inter[0::2] = s.imag
            inter[1::2] = s.real
        else:
            inter[0::2] = s.real
            inter[1::2] = s.imag
        if fmt == "cu8":
            raw = np.clip(np.round(inter * 127.5 + 127.5), 0, 255
                          ).astype(np.uint8).tobytes()
        elif fmt == "cs16":
            raw = np.clip(np.round(inter * 32768.0), -32768, 32767
                          ).astype("<i2").tobytes()
        else:
            raw = inter.astype("<f4").tobytes()
        if self._capped or (self.max_bytes
                            and self.accepted_bytes + len(raw)
                            > self.max_bytes):
            # latch: accepting a LATER smaller chunk after a drop
            # would splice discontinuous samples into the capture
            # with no journal marker
            self._capped = True
            self.drops += s.size
            return 0
        self._f.write(raw)
        self.accepted_bytes += len(raw)
        return len(raw)

    def record_event(self, kind: str, **fields) -> IqEvent:
        ev = IqEvent(kind=kind, byte_offset=self.accepted_bytes, **fields)
        self.events.append(ev)
        if kind == "retune":
            self.meta.contains_retunes = True
        return ev

    def close(self) -> None:
        if self._closed:
            return
        self._f.close()
        self._closed = True
        self.meta.data_file = os.path.basename(self.path)
        self.meta.data_bytes = self.accepted_bytes
        d = self.meta.to_json_dict()
        d["capture_retune_count"] = sum(
            1 for e in self.events if e.kind == "retune")
        d["capture_drops"] = self.drops
        if self.events:
            d["events"] = [{
                "kind": e.kind,
                "byte_offset": e.byte_offset,
                "duration_bytes": e.duration_bytes,
                "center_frequency_hz": e.center_frequency_hz,
                "capture_center_frequency_hz": e.capture_center_frequency_hz,
                "sample_rate_hz": e.sample_rate_hz,
                "reason": e.reason,
            } for e in self.events]
        with open(self.path + ".json", "w") as f:
            json.dump(d, f, indent=2)
            f.write("\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_iq_events(meta: IqMetadata) -> list[IqEvent]:
    """Event journal from a capture's sidecar (empty if none)."""
    out = []
    for raw in meta.extra.get("events", []):
        known = {k: raw[k] for k in IqEvent.__dataclass_fields__ if k in raw}
        out.append(IqEvent(**known))
    return out


def replay_segments(meta: IqMetadata, samples: np.ndarray):
    """Split a capture into (center_freq_hz, samples) segments at retune
    events — replay's tuning-timeline reconstruction (reference
    iq_replay.c retune-event playback)."""
    bps = _BYTES_PER_SAMPLE.get(meta.sample_format, 2)
    events = [e for e in read_iq_events(meta) if e.kind == "retune"]
    freq = meta.center_frequency_hz
    start = 0
    for e in sorted(events, key=lambda e: e.byte_offset):
        cut = min(e.byte_offset // bps, len(samples))
        if cut > start:
            yield freq, samples[start:cut]
        start = cut
        freq = e.center_frequency_hz or freq
    if start < len(samples):
        yield freq, samples[start:]
