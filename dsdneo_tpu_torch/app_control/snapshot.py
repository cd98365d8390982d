"""Frontend metric snapshots (reference frontend.h dsd_frontend_metrics).

The producer (engine/live loop) publishes an immutable snapshot per
block under a lock; consumers (terminal UI, tests, remote frontends)
poll ``MetricsHub.snapshot()`` and never see live decoder state.

The port's own copy of ``dsdneo_tpu/app_control/snapshot.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace

import numpy as np


@dataclass(frozen=True)
class DecodeHealth:
    """FEC pass/fail counters per family (reference
    dsd_frontend_decode_health)."""
    p25p1_fec_ok: int = 0
    p25p1_fec_err: int = 0
    dmr_fec_ok: int = 0
    dmr_fec_err: int = 0
    generic_crc_ok: int = 0
    generic_crc_err: int = 0


@dataclass(frozen=True)
class FrontendMetrics:
    """One published snapshot (plain values + small arrays only)."""
    generation: int = 0
    freq_hz: float = 0.0
    stream_active: bool = False
    retunes: int = 0
    input_level_rms: float = 0.0
    snr_db: float = 0.0
    cfo_hz: float = 0.0
    symbol_rate_hz: int = 4800
    blocks: int = 0
    ring_fill: int = 0
    ring_drops: int = 0
    # retune discipline (engine/live): blocks inside the post-retune
    # mute window, and the generation of the last completed tune
    retune_muted: bool = False
    tune_complete_generation: int = 0
    health: DecodeHealth = field(default_factory=DecodeHealth)
    # small visualizer buffers (copies, decimated)
    eye_symbols: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))
    spectrum_db: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))


class MetricsHub:
    """Thread-safe single-writer / many-reader snapshot exchange."""

    def __init__(self):
        self._lock = threading.Lock()
        self._snap = FrontendMetrics()

    def publish(self, **updates) -> FrontendMetrics:
        """Producer side: replace fields, bump the generation."""
        with self._lock:
            snap = replace(self._snap, generation=self._snap.generation + 1,
                           **updates)
            self._snap = snap
        return snap

    def bump_health(self, **deltas) -> None:
        with self._lock:
            h = self._snap.health
            vals = {f: getattr(h, f) + deltas.get(f, 0)
                    for f in h.__dataclass_fields__}
            self._snap = replace(self._snap, health=DecodeHealth(**vals))

    def snapshot(self) -> FrontendMetrics:
        with self._lock:
            return self._snap        # frozen dataclass: safe to share
