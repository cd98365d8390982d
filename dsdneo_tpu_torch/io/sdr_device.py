"""SDR device layer: librtlsdr USB (ctypes) and SoapySDR bindings.

The third leg of the reference's device triad (src/io/radio/
rtl_device.cpp: librtlsdr USB async callback :2341, rtl_tcp client
:2430 — ours in io/rtl_tcp.py — and SoapySDR).  Both backends pump CU8
I/Q into the native ingest ring exactly like the rtl_tcp client, so
LiveEngine/trunking are source-agnostic.

librtlsdr is bound with ctypes against the system library (no compile
step); ``DSDNEO_RTLSDR_LIB`` overrides the library path, which the
tests use to drive the full binding against a compiled stub.  SoapySDR
binds through its Python module when importable.  Both gate cleanly
(raise ``SdrUnavailable``) when the dependency is absent; the tests
drive them against stubs.

The port's own copy of ``dsdneo_tpu/io/sdr_device.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading


class SdrUnavailable(RuntimeError):
    """The requested SDR backend's library/hardware is not present."""


def parse_if_gains(spec: str) -> list[tuple[int, int]]:
    """``"stage:gain[,...]"`` → [(stage, tenth_dB)] — the reference's
    DSD_NEO_RTL_IF_GAINS syntax (rtl_sdr_fm.cpp
    stream_open_parse_if_gain_tenth_db): a trailing ``dB`` is
    stripped; values with a decimal point are dB, integers are dB
    unless |v| > 90 (already tenth-dB)."""
    out: list[tuple[int, int]] = []
    for tok in spec.replace(";", ",").replace(" ", ",").split(","):
        if ":" not in tok:
            continue
        st, _, gv = tok.partition(":")
        try:
            stage = int(st)
        except ValueError:
            continue
        if stage < 0:
            continue
        gv = gv.strip()
        if gv.lower().endswith("db"):
            gv = gv[:-2]
        elif gv.lower().endswith("b"):
            gv = gv[:-1]
        try:
            if "." in gv:
                tenth = int(round(float(gv) * 10))
            else:
                gi = int(gv)
                tenth = gi if abs(gi) > 90 else gi * 10
        except ValueError:
            continue
        out.append((stage, tenth))
    return out


def _load_librtlsdr() -> ctypes.CDLL:
    path = os.environ.get("DSDNEO_RTLSDR_LIB")
    if not path:
        path = ctypes.util.find_library("rtlsdr")
    if not path:
        for cand in ("librtlsdr.so.2", "librtlsdr.so.0", "librtlsdr.so"):
            try:
                return ctypes.CDLL(cand)
            except OSError:
                continue
        raise SdrUnavailable("librtlsdr not found")
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise SdrUnavailable(f"librtlsdr load failed: {e}")


class RtlUsbDevice:
    """librtlsdr USB tuner (reference rtl_device.cpp librtlsdr backend).

    A reader thread pulls CU8 via ``rtlsdr_read_sync`` and writes into
    the ingest ring (the reference uses the async callback API; the
    sync loop is equivalent for our block-pipelined consumer and keeps
    the ctypes surface minimal)."""

    DEFAULT_BLOCK = 16384        # reference DEFAULT_BUF_LENGTH

    def __init__(self, ring, index: int = 0, sample_rate: int = 2_400_000,
                 freq_hz: int = 851_000_000, gain_tenth_db: int | None = None,
                 ppm: int = 0, bias_tee: bool = False,
                 direct_sampling: int = 0, agc: bool = False,
                 bandwidth_hz: int = 0):
        self._lib = _load_librtlsdr()
        lib = self._lib
        lib.rtlsdr_get_device_count.restype = ctypes.c_uint32
        n = lib.rtlsdr_get_device_count()
        if n <= index:
            raise SdrUnavailable(f"rtlsdr device {index} not present ({n} found)")
        self._dev = ctypes.c_void_p()
        if lib.rtlsdr_open(ctypes.byref(self._dev), index) != 0:
            raise SdrUnavailable(f"rtlsdr_open({index}) failed")
        self.ring = ring
        self._stop = False
        self._thread: threading.Thread | None = None
        self.sample_rate = sample_rate
        self.freq_hz = freq_hz
        if lib.rtlsdr_set_sample_rate(self._dev,
                                      ctypes.c_uint32(sample_rate)) != 0:
            lib.rtlsdr_close(self._dev)
            raise SdrUnavailable(
                f"rtlsdr_set_sample_rate({sample_rate}) rejected "
                "(valid ~225 kHz - 3.2 MHz)")
        lib.rtlsdr_set_center_freq(self._dev, ctypes.c_uint32(freq_hz))
        if ppm:
            lib.rtlsdr_set_freq_correction(self._dev, ctypes.c_int(ppm))
        if gain_tenth_db is None:
            lib.rtlsdr_set_tuner_gain_mode(self._dev, 0)     # auto
        else:
            lib.rtlsdr_set_tuner_gain_mode(self._dev, 1)
            lib.rtlsdr_set_tuner_gain(self._dev,
                                      ctypes.c_int(gain_tenth_db))
        if bias_tee and hasattr(lib, "rtlsdr_set_bias_tee"):
            lib.rtlsdr_set_bias_tee(self._dev, 1)
        # driver-option knobs (reference rtl_sdr_fm.cpp stream_open_
        # apply_* helpers, docs/cli.md:573-582); all gate on symbol
        # presence so older librtlsdr builds still bind
        from dsdneo_tpu_torch.runtime import config as rtcfg
        cfg = rtcfg.get()
        if not direct_sampling:
            direct_sampling = cfg.rtl_direct      # DSD_NEO_RTL_DIRECT
        if direct_sampling:
            lib.rtlsdr_set_direct_sampling(self._dev,
                                           ctypes.c_int(direct_sampling))
        if (cfg.rtl_offset_tuning and not direct_sampling
                and hasattr(lib, "rtlsdr_set_offset_tuning")):
            # DSD_NEO_RTL_OFFSET_TUNING default "try enable": only
            # E4000 tuners support it, so the rc is advisory
            lib.rtlsdr_set_offset_tuning(self._dev, 1)
        if ((cfg.rtl_xtal_hz or cfg.tuner_xtal_hz)
                and hasattr(lib, "rtlsdr_set_xtal_freq")):
            # DSD_NEO_RTL_XTAL_HZ / DSD_NEO_TUNER_XTAL_HZ: 0 keeps the
            # stock 28.8 MHz crystal on that side
            lib.rtlsdr_set_xtal_freq(
                self._dev, ctypes.c_uint32(cfg.rtl_xtal_hz),
                ctypes.c_uint32(cfg.tuner_xtal_hz))
        if cfg.rtl_if_gains and hasattr(lib, "rtlsdr_set_tuner_if_gain"):
            for stage, tenth in parse_if_gains(cfg.rtl_if_gains):
                lib.rtlsdr_set_tuner_if_gain(self._dev,
                                             ctypes.c_int(stage),
                                             ctypes.c_int(tenth))
        if cfg.rtl_testmode and hasattr(lib, "rtlsdr_set_testmode"):
            lib.rtlsdr_set_testmode(self._dev, 1)  # counter ramp source
        if agc and hasattr(lib, "rtlsdr_set_agc_mode"):
            lib.rtlsdr_set_agc_mode(self._dev, 1)    # DSD_NEO_RTL_AGC
        if bandwidth_hz and hasattr(lib, "rtlsdr_set_tuner_bandwidth"):
            lib.rtlsdr_set_tuner_bandwidth(
                self._dev, ctypes.c_uint32(bandwidth_hz))
        if cfg.rtl_verify:
            # DSD_NEO_RTL_VERIFY: read back freq/rate and retry the
            # apply up to DSD_NEO_RTL_VERIFY_ATTEMPTS times (the
            # reference's local-USB apply verification)
            self._verify_applied(cfg.rtl_verify_attempts)
        lib.rtlsdr_reset_buffer(self._dev)

    def _verify_applied(self, attempts: int) -> None:
        lib = self._lib
        if not (hasattr(lib, "rtlsdr_get_center_freq")
                and hasattr(lib, "rtlsdr_get_sample_rate")):
            return
        lib.rtlsdr_get_center_freq.restype = ctypes.c_uint32
        lib.rtlsdr_get_sample_rate.restype = ctypes.c_uint32
        for _ in range(max(1, attempts)):
            ok = True
            if lib.rtlsdr_get_sample_rate(self._dev) != self.sample_rate:
                lib.rtlsdr_set_sample_rate(
                    self._dev, ctypes.c_uint32(self.sample_rate))
                ok = False
            if lib.rtlsdr_get_center_freq(self._dev) != self.freq_hz:
                lib.rtlsdr_set_center_freq(
                    self._dev, ctypes.c_uint32(self.freq_hz))
                ok = False
            if ok:
                return
        from dsdneo_tpu_torch.runtime import log
        log.warning("rtlsdr: apply verification failed after %d attempts",
                    attempts)

    # -- controls (reference rtl_stream C API subset) ---------------------
    def set_freq(self, freq_hz: int) -> None:
        self.freq_hz = int(freq_hz)
        self._lib.rtlsdr_set_center_freq(self._dev,
                                         ctypes.c_uint32(int(freq_hz)))

    def set_ppm(self, ppm: int) -> None:
        self._lib.rtlsdr_set_freq_correction(self._dev, ctypes.c_int(int(ppm)))

    def set_gain(self, tenth_db: int) -> None:
        self._lib.rtlsdr_set_tuner_gain_mode(self._dev, 1)
        self._lib.rtlsdr_set_tuner_gain(self._dev, ctypes.c_int(int(tenth_db)))

    # -- reader ------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self) -> None:
        from dsdneo_tpu_torch.runtime.rt_sched import apply_rt_policy
        apply_rt_policy(role="usb")     # DSD_NEO_RT_PRIO_USB / CPU_USB
        buf = (ctypes.c_ubyte * self.DEFAULT_BLOCK)()
        got = ctypes.c_int(0)
        while not self._stop:
            rc = self._lib.rtlsdr_read_sync(self._dev, buf,
                                            self.DEFAULT_BLOCK,
                                            ctypes.byref(got))
            if rc != 0 or got.value <= 0:
                break
            # string_at copies straight from the C buffer; slicing a
            # ctypes array first would materialize a Python int list
            # per 16 kB block on the latency-sensitive reader thread
            self.ring.write(ctypes.string_at(buf, got.value))

    def close(self) -> None:
        self._stop = True
        if hasattr(self._lib, "rtlsdr_cancel_async"):
            try:
                self._lib.rtlsdr_cancel_async(self._dev)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2)
            if self._thread.is_alive():
                # rtlsdr_read_sync cannot be interrupted; freeing the
                # device under a blocked read is a use-after-free, so
                # leak the handle instead (the daemon thread dies with
                # the process)
                return
        self._lib.rtlsdr_close(self._dev)


class SoapyDevice:
    """SoapySDR RX stream → ingest ring (reference
    rtl_device_create_soapy, rtl_device.h:140).  Binds through the
    SoapySDR Python module; absent module → SdrUnavailable."""

    def __init__(self, ring, driver_args: str = "", sample_rate: int = 2_400_000,
                 freq_hz: int = 851_000_000, gain_db: float | None = None,
                 _module=None):
        if _module is None:
            try:
                import SoapySDR as _module          # pragma: no cover
            except ImportError:
                raise SdrUnavailable("SoapySDR python module not installed")
        self._soapy = _module
        self.dev = _module.Device(driver_args)
        self.ring = ring
        self.sample_rate = sample_rate
        self.freq_hz = freq_hz
        self._stop = False
        self._thread: threading.Thread | None = None
        rx = getattr(_module, "SOAPY_SDR_RX", 1)
        self._rx = rx
        self.dev.setSampleRate(rx, 0, float(sample_rate))
        self.dev.setFrequency(rx, 0, float(freq_hz))
        if gain_db is not None:
            self.dev.setGain(rx, 0, float(gain_db))
        fmt = getattr(_module, "SOAPY_SDR_CU8", "CU8")
        self.stream = self.dev.setupStream(rx, fmt)
        self.dev.activateStream(self.stream)

    def set_freq(self, freq_hz: int) -> None:
        self.freq_hz = int(freq_hz)
        self.dev.setFrequency(self._rx, 0, float(freq_hz))

    def set_ppm(self, ppm: int) -> None:
        try:
            self.dev.setFrequencyCorrection(self._rx, 0, float(ppm))
        except AttributeError:
            pass

    def start(self) -> None:
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self) -> None:
        import numpy as np

        from dsdneo_tpu_torch.runtime.rt_sched import apply_rt_policy
        apply_rt_policy(role="usb")     # DSD_NEO_RT_PRIO_USB / CPU_USB
        buf = np.empty(16384 * 2, dtype=np.uint8)
        while not self._stop:
            sr = self.dev.readStream(self.stream, [buf], 16384)
            n = sr.ret if hasattr(sr, "ret") else sr
            if n is None:
                break
            if n <= 0:
                # SOAPY_SDR_TIMEOUT (-1) / OVERFLOW (-4) are transient;
                # only a genuine stream end (0 after stop) exits
                if n in (-1, -4):
                    continue
                break
            self.ring.write(buf[:2 * n].tobytes())

    def close(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=2)
            if self._thread.is_alive():
                return          # never tear down under a blocked read
        self.dev.deactivateStream(self.stream)
        self.dev.closeStream(self.stream)


class Cu8Decimator:
    """Integer-factor CU8 decimator for device rates the hardware can
    actually run.  Real RTL dongles reject rates below ~225 kHz, so
    live sources sample at ``device_rate = D × ring_rate`` and this
    boxcar-averages D complex samples into one before the ring (a
    CIC-1 prefilter; the channel LPF in the decode chain provides the
    real selectivity, matching the reference's decimate-then-filter
    cascade in rtl_sdr_fm.cpp)."""

    def __init__(self, factor: int):
        self.factor = max(int(factor), 1)
        self._carry = b""

    def __call__(self, data: bytes) -> bytes:
        import numpy as np
        if self.factor == 1:
            return data
        buf = self._carry + data
        step = 2 * self.factor
        n_out = len(buf) // step
        if n_out == 0:
            self._carry = buf
            return b""
        used = n_out * step
        self._carry = buf[used:]
        x = np.frombuffer(buf[:used], dtype=np.uint8).astype(np.float32)
        x = x.reshape(n_out, self.factor, 2).mean(axis=1)
        return np.clip(np.round(x), 0, 255).astype(np.uint8).tobytes()


def pick_device_rate(ring_rate: int, minimum: int = 240_000,
                     maximum: int = 3_200_000) -> tuple[int, int]:
    """Smallest valid integer multiple of ``ring_rate`` the tuner
    accepts → (device_rate, decimation factor)."""
    d = -(-minimum // ring_rate)
    rate = d * ring_rate
    if rate > maximum:
        raise SdrUnavailable(f"no valid device rate for {ring_rate}")
    return rate, d


class _DecimatingRing:
    """Ring adapter applying a Cu8Decimator before writes."""

    def __init__(self, ring, factor: int):
        self._ring = ring
        self._dec = Cu8Decimator(factor)

    def write(self, data: bytes) -> int:
        out = self._dec(data)
        if out:
            return self._ring.write(out)
        return 0
