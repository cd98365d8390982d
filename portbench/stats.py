"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import numpy as np


def realtime_x(channels: int, block_s: float, n_blocks: int,
               window_s: float) -> float:
    """RF seconds of every channel of every completed block over the
    wall seconds from the window's start to the last completion."""
    if n_blocks <= 0 or window_s <= 0:
        raise ValueError("no block completed in the window")
    return channels * block_s * n_blocks / window_s


def p95_ms(latencies_s) -> float:
    """The 95th percentile (linear interpolation) of every latency, in
    milliseconds."""
    a = np.asarray(latencies_s, dtype=np.float64)
    if a.size == 0:
        raise ValueError("no latency")
    return float(np.percentile(a, 95.0) * 1e3)
