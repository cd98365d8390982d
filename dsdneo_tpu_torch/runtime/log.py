"""Leveled logging with pluggable sinks + per-stage perf CSV probe.

Reference parity: include/dsd-neo/runtime/log.h LOG_ macros with
stderr/platform sinks (env DSD_NEO_LOG_SINK) and the live pipeline perf
probe flushed to ``dsd-neo-rtl-perf.csv`` (src/io/radio/rtl_perf.cpp:
ingest/demod/output ns, ring fill, drops, SNR per interval).

The port's own copy of ``dsdneo_tpu/runtime/log.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import csv
import sys
import time
from dataclasses import dataclass, field

_LEVELS = {"debug": 0, "info": 1, "notice": 2, "warning": 3, "error": 4}
_state = {"level": 1, "sink": sys.stderr}


def configure(level: str = "info", sink: str = "stderr") -> None:
    _state["level"] = _LEVELS.get(level.lower(), 1)
    if sink == "stderr":
        _state["sink"] = sys.stderr
    elif sink == "stdout":
        _state["sink"] = sys.stdout
    elif sink == "null":
        _state["sink"] = None
    else:
        _state["sink"] = open(sink, "a")


def _log(level: str, msg: str, *args) -> None:
    if _state["sink"] is None or _LEVELS[level] < _state["level"]:
        return
    text = msg % args if args else msg
    print(f"{level.upper()}: {text}", file=_state["sink"])


def debug(msg, *a):
    _log("debug", msg, *a)


def info(msg, *a):
    _log("info", msg, *a)


def notice(msg, *a):
    _log("notice", msg, *a)


def warning(msg, *a):
    _log("warning", msg, *a)


def error(msg, *a):
    _log("error", msg, *a)


@dataclass
class PerfProbe:
    """Per-step timing accumulator flushed to CSV on an interval —
    the host-loop equivalent of the reference's RtlPerfCounters.  Its
    time columns total the tracer's spans (``runtime.trace``) while it
    is attached there (:data:`SPAN_COLUMNS`); ``add`` closes a step."""

    SPAN_COLUMNS = {"live.ingest": "ingest_ms", "live.decode": "decode_ms"}

    path: str
    interval_s: float = 1.0
    fields_: list[str] = field(default_factory=lambda: [
        "ts", "steps", "ingest_ms", "device_ms", "decode_ms",
        "channels", "symbols", "drops"])
    _acc: dict = field(default_factory=dict)
    _last_flush: float = field(default_factory=time.monotonic)
    _writer: csv.DictWriter | None = None
    _f: object = None

    def __post_init__(self):
        if self.path:
            self._f = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._f, fieldnames=self.fields_)
            if self._f.tell() == 0:
                self._writer.writeheader()
        self.reset()

    def reset(self):
        self._acc = {k: 0.0 for k in self.fields_}

    def add(self, **kw):
        for k, v in kw.items():
            self._acc[k] = self._acc.get(k, 0.0) + v
        self._acc["steps"] = self._acc.get("steps", 0) + 1
        now = time.monotonic()
        if self._writer and now - self._last_flush >= self.interval_s:
            self._acc["ts"] = round(time.time(), 3)
            self._writer.writerow({k: round(self._acc.get(k, 0), 3)
                                   for k in self.fields_})
            self._f.flush()
            self._last_flush = now
            self.reset()

    def on_span(self, name: str, block, t0_ns: int, t1_ns: int) -> None:
        """A closed span of the tracer, added to the column it feeds."""
        col = self.SPAN_COLUMNS.get(name)
        if col is not None:
            self._acc[col] = self._acc.get(col, 0.0) + (t1_ns - t0_ns) / 1e6

    def flush_now(self) -> None:
        """Write the accumulated row regardless of the interval (end of
        a run: short replays must still record their totals)."""
        if self._writer and self._acc.get("steps"):
            self._acc["ts"] = round(time.time(), 3)
            self._writer.writerow({k: round(self._acc.get(k, 0), 3)
                                   for k in self.fields_})
            self._f.flush()
            self._last_flush = time.monotonic()
            self.reset()

    def close(self):
        if self._f:
            self.flush_now()
            self._f.close()
            self._f = None
