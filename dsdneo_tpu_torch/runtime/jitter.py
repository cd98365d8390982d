"""P25 Phase 2 per-slot audio jitter ring (host, numpy).

The port's own copy of ``dsdneo_tpu/runtime/jitter.py``.  The TDMA voice
cadence delivers 4V/2V bursts irregularly per slot; the ring smooths
them into a steady 160-sample frame stream with bounded latency —
drop-oldest when full, zero-fill when empty (reference contract
include/dsd-neo/runtime/p25_p2_audio_ring.h:31-49).  The serial P25p2
decoder (``protocol.p25.phase2.P25P2Decoder._voice``) pushes each
burst's PCM and drains it.
"""

from __future__ import annotations

from collections import deque

import numpy as np

FRAME = 160


class P2AudioJitterRing:
    """Two independent per-slot rings of 160-sample float frames."""

    def __init__(self, capacity_frames: int = 16):
        self.capacity = capacity_frames
        self._rings = (deque(), deque())
        self.dropped = [0, 0]
        self.underruns = [0, 0]

    def reset(self, slot: int = -1) -> None:
        for s in (0, 1):
            if slot < 0 or slot == s:
                self._rings[s].clear()

    def push(self, slot: int, frame160: np.ndarray) -> bool:
        if slot not in (0, 1) or len(frame160) != FRAME:
            return False
        r = self._rings[slot]
        if len(r) >= self.capacity:
            r.popleft()                  # bounded latency: drop oldest
            self.dropped[slot] += 1
        r.append(np.asarray(frame160, dtype=np.float32).copy())
        return True

    def push_pcm(self, slot: int, pcm: np.ndarray) -> int:
        """Split arbitrary-length PCM into 160-sample frames (the 4V/2V
        burst output) and push each; returns frames pushed."""
        n = len(pcm) // FRAME
        for k in range(n):
            self.push(slot, pcm[k * FRAME:(k + 1) * FRAME])
        return n

    def pop(self, slot: int) -> tuple[np.ndarray, bool]:
        """→ (frame160, had_data); zero-fill on underrun."""
        if slot not in (0, 1) or not self._rings[slot]:
            if slot in (0, 1):
                self.underruns[slot] += 1
            return np.zeros(FRAME, dtype=np.float32), False
        return self._rings[slot].popleft(), True

    def depth(self, slot: int) -> int:
        return len(self._rings[slot])
