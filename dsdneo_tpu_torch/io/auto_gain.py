"""Tuner autogain: closed-loop tuner gain from block statistics.

Rebuild of the reference's experimental autogain controller
(src/io/radio/rtl_sdr_fm.cpp demod_autogain_state/.._update/
.._adjust_manual, env knobs DSD_NEO_TUNER_AUTOGAIN* in
docs/cli.md:584-592).  The decision model is the reference's:

- every block contributes (mean |x|, max |x|) counters: ``high`` when
  the ADC nears full scale (>0.9), ``low`` when the input is quiet
  (<0.06);
- every 40-block window, clipping (``high ≥ 3``) steps gain DOWN 5 dB
  immediately, while a mostly-quiet window (``low ≥ 3/4·blocks``)
  steps gain UP by ``up_step_db`` — but only after the *spectral gate*
  passes ``up_persist`` consecutive windows: spectrum peak SNR over
  the median noise floor ≥ ``spec_snr_db``, the peak inside the center
  region, in-band (center-half) power ratio ≥ ``inband_ratio``, and
  not a DC spur.  The gate stops the loop from amplifying an empty or
  interference-dominated channel;
- changes are throttled (1.5 s) and held off 1.2 s after a retune;
  gain is clamped to the tuner's 0-49 dB range.

The spectral statistics are one ``|fft|²`` per probe window — at
48 kHz block rates this stays in numpy on the host (it gates a
hardware control, not the decode path).

The port's own copy of ``dsdneo_tpu/io/auto_gain.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import time

import numpy as np


class TunerAutogain:
    """Drives ``set_gain_tenth_db`` from per-block input statistics."""

    def __init__(self, set_gain_tenth_db, probe_ms: int = 3000,
                 seed_db: float = 30.0, spec_snr_db: float = 6.0,
                 inband_ratio: float = 0.60, up_step_db: float = 3.0,
                 up_persist: int = 2, window_blocks: int = 40,
                 now_fn=time.monotonic):
        self._set = set_gain_tenth_db
        self.probe_ms = probe_ms
        self.seed_db10 = int(round(seed_db * 10))
        self.spec_snr_db = spec_snr_db
        self.inband_ratio = inband_ratio
        self.up_step_db10 = int(round(up_step_db * 10))
        self.up_persist = up_persist
        self.window_blocks = window_blocks
        self._now = now_fn
        self.target_db10 = self._clamp(self.seed_db10)
        self.blocks = self.high = self.low = 0
        self.spec_pass = 0
        self.adjustments = 0
        self._hold_until = now_fn() + 1.2
        self._next_allowed = 0.0
        self._last_spec: np.ndarray | None = None
        self._seeded = False

    @staticmethod
    def _clamp(db10: int) -> int:
        return max(0, min(490, db10))     # reference clamp_db10

    def on_retune(self) -> None:
        """Reference demod_autogain_reset_window: post-retune settle."""
        self.blocks = self.high = self.low = 0
        self.spec_pass = 0
        self._hold_until = self._now() + 1.2

    def _apply(self) -> None:
        self._set(self.target_db10)
        self.adjustments += 1
        self._next_allowed = self._now() + 1.5
        self.spec_pass = 0

    def _spectral_gate(self, x: np.ndarray) -> bool:
        n = min(len(x), 2048)
        if n < 64:
            return False
        spec = np.abs(np.fft.fftshift(np.fft.fft(x[:n])))
        spec_db = 20.0 * np.log10(np.maximum(spec, 1e-12))
        i_max = int(np.argmax(spec_db))
        p_max = spec_db[i_max]
        noise_med = float(np.median(spec_db))
        # center region = middle half of the shifted spectrum
        i0, i1 = n // 4, 3 * n // 4
        power = spec ** 2
        ratio_center = float(power[i0:i1].sum() / max(power.sum(), 1e-30))
        dc = n // 2
        dc_spur = abs(i_max - dc) <= 2 and \
            p_max > noise_med + 20.0 and ratio_center < self.inband_ratio
        ok = (not dc_spur and i0 <= i_max < i1
              and (p_max - noise_med) >= self.spec_snr_db
              and ratio_center >= self.inband_ratio)
        self.spec_pass = self.spec_pass + 1 if ok else 0
        return self.spec_pass >= self.up_persist

    def update(self, samples: np.ndarray, squelch_open: bool = True) -> None:
        """Feed one demod block (complex, full scale ≈ ±1)."""
        if not self._seeded:
            # seed the tuner out of device-auto at the configured gain
            self._seeded = True
            self._apply()
        a = np.abs(samples)
        self.blocks += 1
        if float(a.max(initial=0.0)) > 0.9:
            self.high += 1
        if (float(a.mean()) if a.size else 0.0) < 0.06:
            self.low += 1
        self._last_spec = samples
        if self.blocks < self.window_blocks:
            return
        now = self._now()
        if now >= self._hold_until and now >= self._next_allowed:
            if self.high >= 3:
                # clipping: back off hard (reference −50 db10)
                self.target_db10 = self._clamp(self.target_db10 - 50)
                self._apply()
            elif (squelch_open and self.low >= (self.blocks * 3) // 4
                    and self._spectral_gate(samples)):
                self.target_db10 = self._clamp(
                    self.target_db10 + self.up_step_db10)
                self._apply()
        self.blocks = self.high = self.low = 0
