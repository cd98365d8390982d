"""Sync warm-start calibration (reference src/dsp/sync_calibration.c,
env DSD_NEO_SYNC_WARMSTART).

Persists per-mode sync statistics from successful decodes — the median
accepted correlation score — and derives a warm-start threshold for the
next run (0.85x the learned median, floored at the default), so a
marginal channel locks faster on restart.

The port's own copy of ``dsdneo_tpu/runtime/calibration.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import json
import os


class SyncCalibration:
    def __init__(self, path: str):
        self.path = path
        self.data: dict[str, dict] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self.data = json.load(f)
            except (OSError, ValueError):
                self.data = {}

    def threshold_for(self, mode: str, default: float) -> float:
        ent = self.data.get(mode)
        if not ent or "median_score" not in ent:
            return default
        warm = 0.85 * float(ent["median_score"])
        return max(min(warm, 0.95), default * 0.8)

    def record(self, mode: str, scores: list[float]) -> None:
        if not scores:
            return
        ss = sorted(scores)
        med = ss[len(ss) // 2]
        ent = self.data.setdefault(mode, {})
        # exponential blend with prior runs
        prior = ent.get("median_score")
        ent["median_score"] = med if prior is None else \
            0.7 * float(prior) + 0.3 * med
        ent["runs"] = int(ent.get("runs", 0)) + 1

    def save(self) -> None:
        if not self.path:
            return
        try:
            with open(self.path, "w") as f:
                json.dump(self.data, f)
        except OSError:
            pass
