"""Network audio/control IO: UDP/TCP PCM input, UDP audio out, rigctl.

Reference parity:
  - UDP PCM16LE input ring (src/io/audio_backends/udp_input.c)
  - TCP PCM16LE input with reconnect watchdog (tcp_input.c)
  - UDP PCM blaster output (udp_audio.c)
  - rigctl TCP client for external SDR retuning (src/io/control/
    dsd_rigctl.c — ``F <hz>`` / ``f`` protocol)
  - UDP retune control server (udp_control.cpp)

The port's own copy of ``dsdneo_tpu/io/net.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

import numpy as np


class UdpPcmInput:
    """Receives 16-bit little-endian PCM datagrams into a ring."""

    def __init__(self, bind: str = "127.0.0.1", port: int = 7355,
                 capacity: int = 1 << 20):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((bind, port))
        self.sock.settimeout(0.25)
        self.buf = np.zeros(capacity, dtype=np.int16)
        self.head = 0
        self.tail = 0
        self.capacity = capacity
        self.drops = 0
        self._stop = False
        self._lock = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            samples = np.frombuffer(data, dtype="<i2")
            with self._lock:
                free = self.capacity - (self.head - self.tail)
                take = min(len(samples), free)
                # two-segment slice assignment (a per-sample Python
                # loop under the lock starved readers at 48 kHz)
                off = self.head % self.capacity
                first = min(take, self.capacity - off)
                self.buf[off:off + first] = samples[:first]
                self.buf[:take - first] = samples[first:take]
                self.head += take
                self.drops += len(samples) - take
                self._lock.notify_all()

    def read(self, n: int, timeout: float = 1.0) -> Optional[np.ndarray]:
        with self._lock:
            if not self._lock.wait_for(
                    lambda: self.head - self.tail >= n or self._stop,
                    timeout=timeout):
                return None
            if self.head - self.tail < n:
                return None
            idx = (self.tail + np.arange(n)) % self.capacity
            out = self.buf[idx].copy()
            self.tail += n
            return out

    def close(self):
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass


class TcpPcmInput:
    """TCP PCM16LE stream input (e.g. from SDR software).

    ``backoff_ms`` (DSD_NEO_TCPIN_BACKOFF_MS, reference tcp_input.c):
    sleep this long after a read timeout before reporting the stall —
    paces the retry loop against a source that's alive but idle."""

    def __init__(self, host: str, port: int, timeout: float = 3.0,
                 backoff_ms: float = 0.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self.backoff_ms = backoff_ms
        self._pending = b""      # partial bytes kept across timeouts

    def read(self, n: int) -> Optional[np.ndarray]:
        """One block of n samples, or None on timeout.  Bytes already
        received when a timeout hits are KEPT for the next call:
        discarding them would both lose samples and shift the int16
        stream off its byte alignment for the rest of the session."""
        need = 2 * n - len(self._pending)
        chunks = [self._pending] if self._pending else []
        while need > 0:
            try:
                data = self.sock.recv(need)
            except socket.timeout:
                self._pending = b"".join(chunks)
                if self.backoff_ms > 0:
                    import time
                    time.sleep(self.backoff_ms / 1e3)
                return None
            if not data:
                self._pending = b"".join(chunks)
                return None
            chunks.append(data)
            need -= len(data)
        self._pending = b""
        return np.frombuffer(b"".join(chunks), dtype="<i2")

    def close(self):
        self.sock.close()


class UdpAudioOutput:
    """Blasts decoded PCM16LE to a UDP sink."""

    def __init__(self, host: str = "127.0.0.1", port: int = 23456,
                 chunk: int = 320):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.chunk = chunk

    def write(self, pcm: np.ndarray) -> None:
        x = np.asarray(pcm)
        if x.dtype != np.int16:
            x = (np.clip(x, -1, 1) * 32767).astype("<i2")
        for i in range(0, len(x), self.chunk):
            self.sock.sendto(x[i:i + self.chunk].tobytes(), self.addr)

    def close(self):
        self.sock.close()


class RigctlClient:
    """Hamlib rigctld protocol client for external tuner control."""

    def __init__(self, host: str = "127.0.0.1", port: int = 4532,
                 timeout: float = 2.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)

    def set_freq(self, hz: float) -> bool:
        self.sock.sendall(f"F {int(hz)}\n".encode())
        resp = self.sock.recv(64)
        return b"RPRT 0" in resp or resp.strip() == b""

    def get_freq(self) -> Optional[float]:
        self.sock.sendall(b"f\n")
        try:
            return float(self.sock.recv(64).split()[0])
        except (ValueError, IndexError, socket.timeout):
            return None

    def set_mode(self, mode: str = "FM", passband_hz: int = 0) -> bool:
        """rigctl 'M <mode> <passband>' — the reference -B setmod
        bandwidth push after each retune (args.c case 'B')."""
        self.sock.sendall(f"M {mode} {int(passband_hz)}\n".encode())
        try:
            resp = self.sock.recv(64)
        except socket.timeout:
            return False
        return b"RPRT 0" in resp or resp.strip() == b""

    def close(self):
        self.sock.close()


class UdpControlServer:
    """UDP retune control: text datagrams ``TUNE <hz>`` / ``STOP`` invoke
    a callback (reference udp_control.h:30-43 callback API)."""

    def __init__(self, on_tune: Callable[[float], None],
                 bind: str = "127.0.0.1", port: int = 4532,
                 on_stop: Callable[[], None] | None = None):
        self.on_tune = on_tune
        self.on_stop = on_stop
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((bind, port))
        self.sock.settimeout(0.25)
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            try:
                data, addr = self.sock.recvfrom(256)
            except socket.timeout:
                continue
            except OSError:
                break
            parts = data.decode(errors="ignore").split()
            try:
                if len(parts) == 2 and parts[0].upper() == "TUNE":
                    try:
                        self.on_tune(float(parts[1]))
                        self.sock.sendto(b"OK\n", addr)
                    except ValueError:
                        self.sock.sendto(b"ERR\n", addr)
                elif parts and parts[0].upper() == "STOP":
                    if self.on_stop is not None:
                        self.on_stop()
                        self.sock.sendto(b"OK\n", addr)
                    else:
                        self.sock.sendto(b"ERR\n", addr)
                elif parts:
                    self.sock.sendto(b"ERR\n", addr)
            except OSError:
                # a failing callback (e.g. rigctl gone) or reply send
                # must not kill the listener thread
                continue

    def close(self):
        self._stop = True
        self.sock.close()


class TcpQualityWatchdog:
    """Throughput watchdog for TCP sample streams (reference
    src/io/radio/tcp_quality_metrics.cpp): after a connection grace
    period, a 3 s window whose received bytes fall below 25% of the
    expected CU8 rate fires a reconnect recommendation (latched)."""

    WINDOW_S = 3.0
    GRACE_S = 5.0
    THRESHOLD = 0.25

    def __init__(self, sample_rate: int, now_fn=None):
        import time as _t
        self.now = now_fn or _t.monotonic
        self.reset(sample_rate)
        self.latched = False

    def reset(self, sample_rate: int) -> None:
        self.sample_rate = sample_rate
        now = self.now()
        self._window_start = now
        self._connected_at = now
        self._bytes = 0
        self.latched = False      # reconnect clears the latch

    def record_recv(self, n_bytes: int) -> bool:
        """Returns True when sustained throughput is below threshold."""
        self._bytes += n_bytes
        now = self.now()
        elapsed = now - self._window_start
        if elapsed < self.WINDOW_S:
            return False
        fired = False
        if now - self._connected_at > self.GRACE_S and self.sample_rate > 0:
            expected = self.sample_rate * 2.0 * elapsed
            fired = (self._bytes / expected) < self.THRESHOLD
            # a latch stays set until reset() (reconnect) — a healthy
            # window in between must not clear the recommendation
            self.latched = self.latched or fired
        self._bytes = 0
        self._window_start = now
        return fired
