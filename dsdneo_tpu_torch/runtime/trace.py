"""Spans and counters at the layer boundaries of the port's hot path.

A span (:func:`span`) times one stretch of host code and carries the
number of the block it serves; a counter (:func:`count`) adds up work
at the same boundaries.  Spans are kept only while ``torch.profiler`` is
recording (PyTorch's own fast flag,
``torch.autograd.profiler._is_profiler_enabled``) or while a sink is
attached (:func:`attach`: ``runtime.log.PerfProbe`` on ``--perf-csv``),
counters only while the profiler records.  Otherwise a span is one flag
check that returns a shared null context, and a counter one flag check.

Stamps are ``time.time_ns()``, the clock the profiler stamps its events
on (ns since the epoch), so a span can be laid beside the profiler's
timeline.  No span opens a profiler range: a ``record_function`` range
would also appear on the device's timeline as a user annotation over
its kernels and be read as device work.

The records made under the profiler are kept in memory, one
:class:`Session` a profiled period (:func:`last_session`).  A period is
told from the one before it by the tracer having seen the profiler off
in between, at a span's close or a call of :func:`last_session`.
"""

from __future__ import annotations

import threading
import time

import torch.autograd.profiler as _prof
from torch.utils.weak import WeakIdKeyDictionary


class Session:
    """What the tracer recorded during one profiled period: ``spans``
    as (name, block, start ns, end ns), ``counts`` as (name, block, n)."""

    def __init__(self):
        self.spans: list[tuple[str, int | None, int, int]] = []
        self.counts: list[tuple[str, int | None, int]] = []

    def ms(self, name: str) -> float:
        """Milliseconds in the spans named ``name``, summed."""
        return 1e-6 * sum(t1 - t0 for n, _b, t0, t1 in self.spans
                          if n == name)

    def total(self, name: str) -> int:
        """The counter ``name``, summed."""
        return sum(k for n, _b, k in self.counts if n == name)


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_sinks: list = []
_lock = threading.Lock()
_session = Session()
_fresh = True            # the next record under the profiler opens a session
_tags = WeakIdKeyDictionary()


class _Span:
    __slots__ = ("name", "block", "t0")

    def __init__(self, name: str, block: int | None):
        self.name, self.block = name, block

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = (self.name, self.block, self.t0, t1)
        if _prof._is_profiler_enabled:
            with _lock:
                _current().spans.append(rec)
        else:
            _seen_off()
        for s in tuple(_sinks):
            s.on_span(*rec)
        return False


def _current() -> Session:
    global _session, _fresh
    if _fresh:
        _session, _fresh = Session(), False
    return _session


def _seen_off() -> None:
    global _fresh
    _fresh = True


def on() -> bool:
    """True while spans are kept: the profiler records or a sink is
    attached."""
    return bool(_sinks) or _prof._is_profiler_enabled


def span(name: str, block: int | None = None):
    """A context that times its body as the span ``name`` of ``block``."""
    if not (_sinks or _prof._is_profiler_enabled):
        return _NULL
    return _Span(name, block)


def count(name: str, n: int, block: int | None = None) -> None:
    """Add ``n`` to the counter ``name`` (kept under the profiler)."""
    if not _prof._is_profiler_enabled:
        return
    with _lock:
        _current().counts.append((name, block, int(n)))


def tag(obj, block: int | None) -> None:
    """Hand ``block`` on with ``obj`` (a handle one call returns and a
    later call takes), while spans are kept."""
    if block is not None and obj is not None and on():
        _tags[obj] = block


def block_of(obj) -> int | None:
    """The block :func:`tag` handed on with ``obj`` while spans are kept,
    or None."""
    if obj is None or not (_sinks or _prof._is_profiler_enabled):
        return None
    try:
        return _tags.get(obj)
    except TypeError:             # an object no weak reference can hold
        return None


def attach(sink) -> None:
    """Send every closed span to ``sink.on_span(name, block, start ns,
    end ns)`` until :func:`detach`; None attaches nothing."""
    if sink is not None:
        _sinks.append(sink)


def detach(sink) -> None:
    _sinks[:] = [s for s in _sinks if s is not sink]


def last_session() -> Session:
    """The spans and counters of the most recent profiled period (the
    current one while the profiler records); empty before any."""
    with _lock:
        if not _prof._is_profiler_enabled:
            _seen_off()
        return _session
