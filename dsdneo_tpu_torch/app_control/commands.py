"""Typed frontend→engine command queue (reference app_command_queue.c).

Bounded, thread-safe, non-blocking on both sides: frontends enqueue
(cmd, payload) and the engine drains between blocks.  A full queue
drops the new command and counts it, like the reference's lock-free
ring does.

The port's own copy of ``dsdneo_tpu/app_control/commands.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import enum
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any


class AppCommand(enum.Enum):
    TUNE = "tune"                    # payload: freq_hz (float)
    SET_MODE = "set_mode"            # payload: mode name (str)
    SET_SQUELCH = "set_squelch"      # payload: dB (float)
    GAIN_DELTA = "gain_delta"        # payload: +/- step (int)
    TOGGLE_MUTE = "toggle_mute"
    TG_HOLD = "tg_hold"              # payload: (slot, tg)
    TG_RELEASE = "tg_release"        # payload: slot
    SET_PPM = "set_ppm"              # payload: ppm (int)
    STOP = "stop"


@dataclass(frozen=True)
class QueuedCommand:
    cmd: AppCommand
    payload: Any = None


class CommandQueue:
    def __init__(self, capacity: int = 64):
        self._q: deque[QueuedCommand] = deque()
        self._lock = threading.Lock()
        self.capacity = capacity
        self.dropped = 0

    def put(self, cmd: AppCommand, payload: Any = None) -> bool:
        with self._lock:
            if len(self._q) >= self.capacity:
                self.dropped += 1
                return False
            self._q.append(QueuedCommand(cmd, payload))
            return True

    def drain(self) -> list[QueuedCommand]:
        """Engine side: take everything queued (FIFO order)."""
        with self._lock:
            items = list(self._q)
            self._q.clear()
        return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)
