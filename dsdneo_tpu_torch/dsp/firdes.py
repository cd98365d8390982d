"""FIR designs the port computes itself (host side, numpy).

Counterpart of ``rrc`` in ``dsdneo_tpu/dsp/firdes.py``; the channel
low-pass taps come with the tables file.
"""

from __future__ import annotations

import math

import numpy as np


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
