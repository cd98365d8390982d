"""FIR designs the port computes itself (host side, numpy).

Counterpart of ``rrc``, ``lowpass_taps`` (its Hamming and
Blackman-Harris windows) and ``channel_lpf`` in
``dsdneo_tpu/dsp/firdes.py``: the root-raised-cosine matched filter of
CQPSK, the channel low-pass of the gated front end (the other paths'
channel low-pass taps come with their tables files) and the polyphase
bank of ``dsp.resampler``.
"""

from __future__ import annotations

import math

import numpy as np

# channel low-pass profiles: the transition band's centre in Hz (the
# passband edge and half the 1200 Hz transition)
CH_LPF_TRANSITION_HZ = 1200.0
_GUARD = CH_LPF_TRANSITION_HZ * 0.5
CH_LPF_CUTOFF_HZ = {
    "wide": 8000.0 + _GUARD,
    "6k25": 3125.0 + _GUARD,       # NXDN48, dPMR, D-STAR
    "12k5": 6250.0 + _GUARD,       # DMR, NXDN96, X2-TDMA, YSF, M17
    "provoice": 6250.0 + _GUARD,
    "p25_c4fm": 6250.0 + _GUARD,
    "p25_cqpsk": 7250.0,
}
CH_LPF_TAPS = 144


def _window(kind: str, n: int) -> np.ndarray:
    m = np.arange(n)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * m / (n - 1))
    if kind == "blackman-harris":
        return (0.35875 - 0.48829 * np.cos(2 * np.pi * m / (n - 1))
                + 0.14128 * np.cos(4 * np.pi * m / (n - 1))
                - 0.01168 * np.cos(6 * np.pi * m / (n - 1)))
    raise ValueError(f"unknown window {kind!r}")


def lowpass_taps(ntaps: int, fs: float, cutoff: float,
                 window: str = "hamming") -> np.ndarray:
    """Exactly ``ntaps`` (odd; an even count is raised by one) windowed
    sinc low-pass taps of unit DC gain, float32: Hamming-windowed (the
    channel filters) or Blackman-Harris (the resampler's bank)."""
    if ntaps % 2 == 0:
        ntaps += 1
    m = np.arange(ntaps) - (ntaps - 1) / 2
    fc = cutoff / fs
    h = np.sinc(2 * fc * m) * 2 * fc
    h *= _window(window, ntaps)
    h /= np.sum(h)
    return h.astype(np.float32)


def channel_lpf(fs: float, profile: str,
                ntaps: int = CH_LPF_TAPS - 1) -> np.ndarray:
    """The channel low-pass of a decode profile at sample rate ``fs``
    (143 taps by default)."""
    if ntaps % 2 == 0:
        ntaps -= 1
    return lowpass_taps(ntaps, fs, CH_LPF_CUTOFF_HZ[profile])


def rrc(sps: float, ntaps: int, alpha: float = 0.2) -> np.ndarray:
    """Root-raised-cosine taps (unit energy, float32), symbol period
    ``sps`` samples; an even ``ntaps`` is raised to the next odd count."""
    if ntaps % 2 == 0:
        ntaps += 1
    t = (np.arange(ntaps) - (ntaps - 1) / 2) / sps
    h = np.empty(ntaps)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-8:
            h[i] = 1.0 - alpha + 4 * alpha / math.pi
        elif abs(abs(4 * alpha * ti) - 1.0) < 1e-8:
            h[i] = (alpha / math.sqrt(2)) * (
                (1 + 2 / math.pi) * math.sin(math.pi / (4 * alpha))
                + (1 - 2 / math.pi) * math.cos(math.pi / (4 * alpha)))
        else:
            h[i] = (math.sin(math.pi * ti * (1 - alpha))
                    + 4 * alpha * ti * math.cos(math.pi * ti * (1 + alpha))
                    ) / (math.pi * ti * (1 - (4 * alpha * ti) ** 2))
    h /= np.sqrt(np.sum(h * h))
    return h.astype(np.float32)
