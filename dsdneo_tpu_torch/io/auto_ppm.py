"""Automatic PPM drift correction for unattended operation.

The rebuild of the reference's carrier-based auto-PPM loop
(src/io/radio/rtl_auto_ppm.cpp): per-block CFO estimates are gated by
SNR/power, smoothed, and turned into bounded tuner frequency-correction
steps; after the estimate stays inside the deadband for a while the
loop locks and stops issuing corrections (the reference's zero-lock).
The deadband exceeds half an (integer) ppm step so the loop cannot
limit-cycle around a fractional residual.

The port's own copy of ``dsdneo_tpu/io/auto_ppm.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import numpy as np


def estimate_cfo_hz(iq: np.ndarray, fs: float) -> float:
    """Mean-frequency CFO estimate: the angle of the lag-1
    autocorrelation (phase-slope method).  For centered FM/FSK signals
    the symmetric deviation cancels and the residual is the carrier
    offset."""
    x = np.asarray(iq)
    if x.size < 16:
        return 0.0
    r = np.vdot(x[:-1], x[1:])          # sum conj(x[n]) x[n+1]
    return float(np.angle(r) * fs / (2.0 * np.pi))


class AutoPpm:
    """Feed per-block (cfo_hz, snr_db); issues set_ppm corrections."""

    def __init__(self, set_ppm, center_hz: float,
                 snr_gate_db: float = 9.0, train_blocks: int = 6,
                 max_step_ppm: int = 2, deadband_ppm: float = 0.55,
                 lock_blocks: int = 12, ema: float = 0.3,
                 initial_ppm: int = 0, freeze: bool = False,
                 pwr_gate_db: float = -80.0,
                 zerolock_hz: float = 0.0):
        self.set_ppm = set_ppm
        self.center_hz = float(center_hz)
        self.snr_gate_db = snr_gate_db
        self.train_blocks = train_blocks
        self.max_step_ppm = max_step_ppm
        # DSD_NEO_AUTO_PPM_ZEROLOCK_PPM: the zero-step lock guard — an
        # EMA inside this band counts toward the lock
        self.deadband_ppm = deadband_ppm
        # DSD_NEO_AUTO_PPM_ZEROLOCK_HZ: absolute-frequency lock guard;
        # 0 keeps only the ppm-relative band
        self.zerolock_hz = zerolock_hz
        # DSD_NEO_AUTO_PPM_PWR_DB: absolute signal-power gate — blocks
        # below it never train the loop (reference default −80 dB)
        self.pwr_gate_db = pwr_gate_db
        self.lock_blocks = lock_blocks
        self.alpha = ema
        self.ppm = int(initial_ppm)
        # DSD_NEO_AUTO_PPM_FREEZE: start frozen (measure, never correct)
        self.freeze = freeze
        self.locked = False
        self.corrections = 0
        self._ema: float | None = None
        self._n_est = 0
        self._in_deadband = 0

    def update(self, cfo_hz: float, snr_db: float,
               pwr_db: float | None = None) -> bool:
        """Returns True when a correction was issued this block."""
        if self.locked or self.freeze or snr_db < self.snr_gate_db:
            return False
        if pwr_db is not None and pwr_db < self.pwr_gate_db:
            return False
        if self._ema is None:
            self._ema = cfo_hz
        else:
            self._ema += self.alpha * (cfo_hz - self._ema)
        self._n_est += 1
        if self._n_est < self.train_blocks:
            return False
        err_ppm = self._ema / self.center_hz * 1e6
        if (abs(err_ppm) <= self.deadband_ppm
                or (self.zerolock_hz > 0
                    and abs(self._ema) <= self.zerolock_hz)):
            self._in_deadband += 1
            if self._in_deadband >= self.lock_blocks:
                self.locked = True
            return False
        self._in_deadband = 0
        # librtlsdr convention: correction p scales the assumed xtal,
        # LO = f_req·(1+e)/(1+p) for true crystal error e, so the
        # observed carrier offset is (p−e)·f·1e-6 — a POSITIVE measured
        # offset requires a NEGATIVE ppm step (the reference validated
        # this on hardware: rtl_auto_ppm.cpp
        # rtl_auto_ppm_fsk_dc_est_to_cfo_hz "positive dc_est must
        # request a negative PPM correction")
        step = int(np.clip(round(-err_ppm), -self.max_step_ppm,
                           self.max_step_ppm))
        if step == 0:
            step = -1 if err_ppm > 0 else 1
        self.ppm += step
        self.corrections += 1
        self.set_ppm(self.ppm)
        # the applied step changes the observed CFO; restart the EMA
        self._ema = None
        self._n_est = 0
        return True
