"""rtl_tcp client: the SDR device layer over plain TCP.

Implements the rtl_tcp wire protocol (the same one the reference's TCP
backend speaks, src/io/radio/rtl_device.cpp:3272-3460): on connect the
server sends a 12-byte header ``'RTL0' + tuner_type(4,BE) +
gain_count(4,BE)``; the client issues 5-byte commands ``cmd(1) +
value(4,BE)`` and the server streams interleaved CU8 I/Q.  The reader
thread feeds the native ingest ring, so LiveEngine's purge-on-retune
discipline applies unchanged.

The port's own copy of ``dsdneo_tpu/io/rtl_tcp.py`` (host Python),
unchanged in its logic but for one fault it does not copy: the test
server ``FakeRtlTcpServer`` waits until its pacing budget allows the
next chunk, where the JAX copy spins.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

# rtl_tcp command ids (the public rtl_tcp protocol)
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_AGC_MODE = 0x08
CMD_SET_BIAS_TEE = 0x0E


class RtlTcpClient:
    """Connect to an rtl_tcp server and pump CU8 into a ring."""

    def __init__(self, host: str, port: int, ring,
                 sample_rate: int = 2_400_000, freq_hz: int = 851_000_000,
                 gain_tenth_db: int | None = None, ppm: int = 0,
                 bias_tee: bool = False, chunk: int | None = None,
                 timeout_s: float | None = None):
        # link-tuning knobs (reference rtl_device.cpp TCP backend,
        # docs/cli.md:562-571): DSD_NEO_TCP_BUFSZ read size,
        # DSD_NEO_TCP_RCVTIMEO socket timeout, DSD_NEO_TCP_RCVBUF
        # SO_RCVBUF, DSD_NEO_TCP_WAITALL full reads,
        # DSD_NEO_TCP_MAX_TIMEOUTS give-up bound, DSD_NEO_TCP_PREBUF_MS
        # startup prebuffer, DSD_NEO_TCP_AUTOTUNE adaptive read size,
        # DSD_NEO_TCP_STATS periodic throughput lines
        from dsdneo_tpu_torch.runtime import config as rtcfg
        cfg = rtcfg.get()
        self.ring = ring
        self.chunk = chunk if chunk is not None else cfg.tcp_bufsz
        if timeout_s is None:
            timeout_s = cfg.tcp_rcvtimeo_ms / 1e3
        if timeout_s is not None and timeout_s <= 0:
            # SO_RCVTIMEO=0 means "block forever"; Python's
            # settimeout(0.0) would instead mean NON-blocking (recv
            # raising BlockingIOError and killing the reader)
            timeout_s = None
        self.waitall = cfg.tcp_waitall
        self.max_timeouts = cfg.tcp_max_timeouts
        self.autotune = cfg.tcp_autotune
        self.stats = cfg.tcp_stats
        self.timeouts = 0
        self._prebuf_bytes = 0      # set by start() from the rate
        self._prebuf_ms = cfg.tcp_prebuf_ms
        self._sample_rate = sample_rate
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._sock.settimeout(timeout_s)
        try:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                  cfg.tcp_rcvbuf)
        except OSError:
            pass
        self.tuner_type, self.gain_count = self._read_header()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.bytes_received = 0
        self.freq_hz = freq_hz
        self.ppm = ppm

        self.set_sample_rate(sample_rate)
        if gain_tenth_db is None:
            self.send_cmd(CMD_SET_GAIN_MODE, 0)        # auto gain
        else:
            self.send_cmd(CMD_SET_GAIN_MODE, 1)
            self.send_cmd(CMD_SET_GAIN, gain_tenth_db)
        if ppm:
            self.set_ppm(ppm)
        if bias_tee:
            self.send_cmd(CMD_SET_BIAS_TEE, 1)
        self.set_freq(freq_hz)

    def _read_header(self) -> tuple[int, int]:
        hdr = b""
        while len(hdr) < 12:
            part = self._sock.recv(12 - len(hdr))
            if not part:
                raise ConnectionError("rtl_tcp: server closed during header")
            hdr += part
        if hdr[:4] != b"RTL0":
            raise ConnectionError(f"rtl_tcp: bad magic {hdr[:4]!r}")
        tuner, ngains = struct.unpack(">II", hdr[4:12])
        return tuner, ngains

    # -- control ---------------------------------------------------------
    def send_cmd(self, cmd: int, value: int) -> None:
        with self._lock:
            self._sock.sendall(struct.pack(">BI", cmd, value & 0xFFFFFFFF))

    def set_freq(self, freq_hz: int) -> None:
        self.freq_hz = int(freq_hz)
        self.send_cmd(CMD_SET_FREQ, int(freq_hz))

    def set_sample_rate(self, rate: int) -> None:
        self.send_cmd(CMD_SET_SAMPLE_RATE, int(rate))

    def set_gain(self, tenth_db: int) -> None:
        """Manual tuner gain in tenth-dB (autogain control hook)."""
        self.send_cmd(CMD_SET_GAIN_MODE, 1)
        self.send_cmd(CMD_SET_GAIN, int(tenth_db))

    def set_ppm(self, ppm: int) -> None:
        self.ppm = int(ppm)
        # rtl_tcp takes the correction as a signed 32-bit value
        self.send_cmd(CMD_SET_FREQ_CORRECTION, int(ppm) & 0xFFFFFFFF)

    # -- streaming ---------------------------------------------------------
    def start(self) -> None:
        # DSD_NEO_TCP_PREBUF_MS: accumulate this much signal before the
        # first ring write so the demod loop never starves on jittery
        # links (2 bytes per CU8 sample)
        self._prebuf_bytes = int(2 * self._sample_rate
                                 * self._prebuf_ms / 1e3)
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self) -> None:
        import time
        from dsdneo_tpu_torch.runtime.rt_sched import apply_rt_policy
        apply_rt_policy(role="dongle")
        prebuf: list[bytes] = []
        prebuf_n = 0
        t_stat = time.monotonic()
        stat_bytes = 0
        while not self._stop.is_set():
            try:
                if self.waitall:
                    # DSD_NEO_TCP_WAITALL: full-chunk reads.  A Python
                    # socket with a timeout is internally non-blocking,
                    # where MSG_WAITALL silently degrades to "whatever
                    # is available" — loop explicitly instead.
                    parts, need = [], self.chunk
                    while need > 0 and not self._stop.is_set():
                        d = self._sock.recv(need)
                        if not d:
                            break
                        parts.append(d)
                        need -= len(d)
                    data = b"".join(parts)
                else:
                    data = self._sock.recv(self.chunk)
            except socket.timeout:
                self.timeouts += 1
                # DSD_NEO_TCP_MAX_TIMEOUTS: consecutive stalls = link
                # is dead; stop instead of spinning forever
                if self.max_timeouts and self.timeouts >= self.max_timeouts:
                    break
                continue
            except OSError:
                break
            if not data:
                break
            self.timeouts = 0
            self.bytes_received += len(data)
            stat_bytes += len(data)
            if self.autotune:
                # DSD_NEO_TCP_AUTOTUNE: grow the read size while the
                # link saturates it, shrink on partial reads — keeps
                # syscall overhead proportional to the actual rate
                if len(data) == self.chunk and self.chunk < (1 << 20):
                    self.chunk *= 2
                elif len(data) < self.chunk // 4 and self.chunk > 4096:
                    self.chunk //= 2
            if self._prebuf_bytes > 0:
                prebuf.append(data)
                prebuf_n += len(data)
                if prebuf_n < self._prebuf_bytes:
                    continue
                data = b"".join(prebuf)
                prebuf, prebuf_n = [], 0
                self._prebuf_bytes = 0     # prebuffer satisfied
            self.ring.write(data)
            if self.stats:
                now = time.monotonic()
                if now - t_stat >= 5.0:
                    from dsdneo_tpu_torch.runtime import log
                    log.info("rtl_tcp: %.2f MB/s, ring fill %d, chunk %d",
                             stat_bytes / (now - t_stat) / 1e6,
                             getattr(self.ring, "fill", 0), self.chunk)
                    t_stat, stat_bytes = now, 0

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        if self._thread is not None:
            self._thread.join(timeout=3)


class FakeRtlTcpServer:
    """Test double: speaks the rtl_tcp protocol, records commands, and
    streams caller-provided CU8 bytes (fixture payloads)."""

    def __init__(self, payload: bytes, tuner_type: int = 5,
                 gain_count: int = 29, chunk: int = 65536,
                 pace_bytes_per_s: int = 0):
        # pace_bytes_per_s > 0 throttles the stream like a real
        # rtl_tcp server (bounded by the SDR sample rate) instead of
        # blasting at socket speed — soak tests need a sustained feed
        self.payload = payload
        self.chunk = chunk
        self.pace = pace_bytes_per_s
        self.commands: list[tuple[int, int]] = []
        self._hdr = b"RTL0" + struct.pack(">II", tuner_type, gain_count)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        try:
            self._srv.settimeout(5.0)
            conn, _ = self._srv.accept()
        except OSError:
            return
        conn.settimeout(0.01)
        conn.sendall(self._hdr)
        sent = 0
        cmdbuf = b""
        while not self._stop.is_set():
            try:
                part = conn.recv(4096)
                if part:
                    cmdbuf += part
                    while len(cmdbuf) >= 5:
                        cmd, val = struct.unpack(">BI", cmdbuf[:5])
                        self.commands.append((cmd, val))
                        cmdbuf = cmdbuf[5:]
                elif part == b"":
                    break
            except socket.timeout:
                pass
            except OSError:
                break
            if sent < len(self.payload):
                n = min(self.chunk, len(self.payload) - sent)
                if self.pace:
                    if not hasattr(self, "_t0"):
                        self._t0 = time.monotonic()
                    # wait until the pace allows the whole next chunk
                    # (polling commands meanwhile) instead of spinning
                    # on an empty budget
                    wait = self._t0 + (sent + n) / self.pace \
                        - time.monotonic()
                    if wait > 0:
                        self._stop.wait(min(wait, 0.05))
                        continue
                try:
                    conn.sendall(self.payload[sent:sent + n])
                    sent += n
                except OSError:
                    break
        try:
            conn.close()
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=3)
