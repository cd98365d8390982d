"""Audio output backends + 2-slot mixing.

The rebuild of the reference's playSynthesizedVoice* family and
platform audio backends (src/core/audio/dsd_audio.c:798, the
pulse/portaudio/null backends in src/platform/): a uniform sink API
over per-slot 8 kHz float PCM with

  - null sink (reference audio_null.c),
  - mono WAV / raw PCM file sinks,
  - stereo WAV sink mixing TDMA slot 0 → left, slot 1 → right
    (the reference's 2-slot stereo playback variants),
  - UDP PCM blaster (io.net.UdpAudioOutput),
  - optional 8k→48k upsample on the way out (dsd_audio upsample path).

The device sinks (PulseAudio, ALSA, a player process) raise when their
library or program is missing; the file and UDP sinks stand behind the
same API.

The port's own copy of ``dsdneo_tpu/io/audio_out.py`` (host Python,
numpy), unchanged in its logic.
"""

from __future__ import annotations

import os

import numpy as np

from dsdneo_tpu_torch.io.audio_files import write_wav


class AudioSink:
    """write(slot, pcm8k) any number of times, then close()."""

    def write(self, slot: int, pcm: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(AudioSink):
    def __init__(self):
        self.samples = 0

    def write(self, slot: int, pcm: np.ndarray) -> None:
        self.samples += len(pcm)


class WavSink(AudioSink):
    """Mono per-slot WAV files (slot suffix added when both slots talk)."""

    def __init__(self, path: str, rate: int = 8000):
        self.path = path
        self.rate = rate
        self._chunks: dict[int, list[np.ndarray]] = {}

    def write(self, slot: int, pcm: np.ndarray) -> None:
        self._chunks.setdefault(slot, []).append(np.asarray(pcm))

    def close(self) -> None:
        for slot, chunks in self._chunks.items():
            path = self.path
            if len(self._chunks) > 1:
                # suffix must apply to extension-less paths too, or
                # both slots write (and the first overwrites) the
                # same file
                root, ext = os.path.splitext(self.path)
                path = f"{root}.s{slot}{ext or '.wav'}"
            write_wav(path, np.concatenate(chunks), self.rate)


class StereoWavSink(AudioSink):
    """2-slot TDMA stereo mix: slot 0 → left, slot 1 → right, written as
    one interleaved 2-channel WAV (reference playSynthesizedVoiceSS)."""

    def __init__(self, path: str, rate: int = 8000):
        self.path = path
        self.rate = rate
        self._chunks: dict[int, list[np.ndarray]] = {0: [], 1: []}

    def write(self, slot: int, pcm: np.ndarray) -> None:
        self._chunks.setdefault(slot & 1, []).append(np.asarray(pcm))

    def close(self) -> None:
        import wave
        left = np.concatenate(self._chunks[0]) if self._chunks[0] else \
            np.zeros(0, dtype=np.float32)
        right = np.concatenate(self._chunks[1]) if self._chunks[1] else \
            np.zeros(0, dtype=np.float32)
        n = max(len(left), len(right))
        if n == 0:
            return
        st = np.zeros((n, 2), dtype=np.float32)
        st[:len(left), 0] = left
        st[:len(right), 1] = right
        x = (np.clip(st, -1, 1) * 32767).astype(np.int16)
        with wave.open(self.path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(self.rate)
            w.writeframes(x.tobytes())


class PcmSink(AudioSink):
    """Raw little-endian int16 mono stream file."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, slot: int, pcm: np.ndarray) -> None:
        x = (np.clip(np.asarray(pcm), -1, 1) * 32767).astype("<i2")
        self._f.write(x.tobytes())

    def close(self) -> None:
        self._f.close()


class PlayerSink(AudioSink):
    """Pipe s16le PCM into an external player process — the stand-in
    for the reference's Pulse/PortAudio device backends
    (src/platform/audio_pulse.c et al.) in environments without a sound
    server.  ``cmd`` defaults to the first of paplay/aplay/ffplay found
    on PATH; any command reading s16le on stdin works
    (e.g. ``-o play:paplay --raw --rate=8000 --channels=1``)."""

    DEFAULTS = (
        "paplay --raw --format=s16le --rate={rate} --channels={ch}",
        "aplay -q -f S16_LE -r {rate} -c {ch}",
        "ffplay -nodisp -autoexit -f s16le -ar {rate} -i -",
    )

    def __init__(self, cmd: str = "", rate: int = 8000,
                 channels: int = 1):
        import shlex
        import shutil
        import subprocess
        if not cmd:
            for cand in self.DEFAULTS:
                if shutil.which(cand.split()[0]):
                    cmd = cand
                    break
            else:
                raise RuntimeError("no audio player (paplay/aplay/ffplay)"
                                   " on PATH; use -o play:<command>")
        self._p = subprocess.Popen(
            shlex.split(cmd.format(rate=rate, ch=channels)),
            stdin=subprocess.PIPE)

    def _send(self, x: np.ndarray) -> None:
        if self._p.stdin is None or self._p.poll() is not None:
            return
        try:
            self._p.stdin.write(x.tobytes())
        except BrokenPipeError:
            pass

    def write(self, slot: int, pcm: np.ndarray) -> None:
        self._send((np.clip(np.asarray(pcm), -1, 1) * 32767
                    ).astype("<i2"))

    def write_frames(self, frames: np.ndarray) -> None:
        """Interleaved multichannel float [n, ch] → s16le stream."""
        self._send((np.clip(np.asarray(frames), -1, 1) * 32767
                    ).astype("<i2"))

    def close(self) -> None:
        if self._p.stdin is not None:
            try:
                self._p.stdin.close()
            except BrokenPipeError:
                pass
        self._p.wait(timeout=5)


class PulseSimpleSink(AudioSink):
    """Native PulseAudio playback through libpulse-simple (ctypes) —
    the reference's Pulse backend (src/platform/audio_pulse.c) without
    an external player process.  ``_lib`` injects a stub for tests."""

    _PA_STREAM_PLAYBACK = 1
    _PA_SAMPLE_S16LE = 3

    def __init__(self, rate: int = 8000, channels: int = 1, _lib=None):
        import ctypes
        import ctypes.util
        self._ct = ctypes
        if _lib is None:
            name = ctypes.util.find_library("pulse-simple")
            if not name:
                raise RuntimeError("libpulse-simple not available")
            _lib = ctypes.CDLL(name)
        self._lib = _lib

        class SampleSpec(ctypes.Structure):
            _fields_ = [("format", ctypes.c_int),
                        ("rate", ctypes.c_uint32),
                        ("channels", ctypes.c_uint8)]

        ss = SampleSpec(self._PA_SAMPLE_S16LE, rate, channels)
        err = ctypes.c_int(0)
        _lib.pa_simple_new.restype = ctypes.c_void_p
        self._s = _lib.pa_simple_new(
            None, b"dsd-neo-tpu", self._PA_STREAM_PLAYBACK, None,
            b"voice", ctypes.byref(ss), None, None, ctypes.byref(err))
        if not self._s:
            raise RuntimeError(f"pa_simple_new failed (err {err.value})")

    def _send(self, x: np.ndarray) -> None:
        err = self._ct.c_int(0)
        buf = x.tobytes()
        self._lib.pa_simple_write(self._ct.c_void_p(self._s), buf,
                                  len(buf), self._ct.byref(err))

    def write(self, slot: int, pcm: np.ndarray) -> None:
        self._send((np.clip(np.asarray(pcm), -1, 1) * 32767
                    ).astype("<i2"))

    def write_frames(self, frames: np.ndarray) -> None:
        self._send((np.clip(np.asarray(frames), -1, 1) * 32767
                    ).astype("<i2"))

    def close(self) -> None:
        if self._s:
            err = self._ct.c_int(0)
            self._lib.pa_simple_drain(self._ct.c_void_p(self._s),
                                      self._ct.byref(err))
            self._lib.pa_simple_free(self._ct.c_void_p(self._s))
            self._s = None


class AlsaSink(AudioSink):
    """Native ALSA playback through libasound (ctypes) — the
    reference's ALSA-family backend.  ``_lib`` injects a stub for
    tests."""

    _SND_PCM_STREAM_PLAYBACK = 0
    _SND_PCM_FORMAT_S16_LE = 2
    _SND_PCM_ACCESS_RW_INTERLEAVED = 3

    def __init__(self, rate: int = 8000, device: str = "default",
                 channels: int = 1, _lib=None):
        import ctypes
        import ctypes.util
        self._ct = ctypes
        if _lib is None:
            name = ctypes.util.find_library("asound")
            if not name:
                raise RuntimeError("libasound not available")
            _lib = ctypes.CDLL(name)
        self._lib = _lib
        pcm = ctypes.c_void_p()
        rc = _lib.snd_pcm_open(ctypes.byref(pcm), device.encode(),
                               self._SND_PCM_STREAM_PLAYBACK, 0)
        if rc < 0:
            raise RuntimeError(f"snd_pcm_open failed ({rc})")
        self._pcm = pcm
        rc = _lib.snd_pcm_set_params(
            pcm, self._SND_PCM_FORMAT_S16_LE,
            self._SND_PCM_ACCESS_RW_INTERLEAVED, channels, rate, 1,
            500000)
        if rc < 0:
            _lib.snd_pcm_close(pcm)
            raise RuntimeError(f"snd_pcm_set_params failed ({rc})")

    def write(self, slot: int, pcm: np.ndarray) -> None:
        x = (np.clip(np.asarray(pcm), -1, 1) * 32767).astype("<i2")
        self._lib.snd_pcm_writei(self._pcm, x.tobytes(), len(x))

    def write_frames(self, frames: np.ndarray) -> None:
        x = (np.clip(np.asarray(frames), -1, 1) * 32767).astype("<i2")
        self._lib.snd_pcm_writei(self._pcm, x.tobytes(), x.shape[0])

    def close(self) -> None:
        if self._pcm:
            self._lib.snd_pcm_drain(self._pcm)
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = None


class FloatWavSink(AudioSink):
    """Mono float32 WAV (WAVE_FORMAT_IEEE_FLOAT) — the reference's -y
    experimental floating point audio output."""

    def __init__(self, path: str, rate: int = 8000):
        self.path = path
        self.rate = rate
        self._chunks: dict[int, list[np.ndarray]] = {}

    def write(self, slot: int, pcm: np.ndarray) -> None:
        self._chunks.setdefault(slot, []).append(
            np.asarray(pcm, dtype=np.float32))

    def close(self) -> None:
        import struct
        for slot, chunks in self._chunks.items():
            path = self.path
            if len(self._chunks) > 1:
                root, ext = os.path.splitext(self.path)
                path = f"{root}.s{slot}{ext or '.wav'}"
            data = np.concatenate(chunks).astype("<f4").tobytes()
            hdr = struct.pack(
                "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE",
                b"fmt ", 16, 3, 1, self.rate, self.rate * 4, 4, 32,
                b"data", len(data))
            with open(path, "wb") as f:
                f.write(hdr + data)


class StreamingUpsampler:
    """Streaming 8 kHz → 48 kHz (×6) polyphase upsampler sharing the
    filter bank of dsp.resampler (host numpy; per-stream history makes
    chunked output exactly equal one-shot resample())."""

    L = 6

    def __init__(self):
        from dsdneo_tpu_torch.dsp.resampler import _plan
        self._bank = np.asarray(_plan(self.L, 1))       # [L, P]
        self._hist = np.zeros(self._bank.shape[1] - 1, np.float32)

    def __call__(self, pcm: np.ndarray) -> np.ndarray:
        pcm = np.asarray(pcm, dtype=np.float32)
        n = pcm.shape[0]
        if n == 0:
            return pcm
        P = self._bank.shape[1]
        x = np.concatenate([self._hist, pcm])
        ks = np.arange(n * self.L)
        ipos = ks // self.L + (P - 1)
        phase = ks % self.L
        idx = ipos[:, None] - np.arange(P)[None, :]
        y = np.sum(x[idx] * self._bank[phase], axis=-1)
        self._hist = x[-(P - 1):]
        return y.astype(np.float32)


class UpmixSink(AudioSink):
    """Live-playback adapter: per-slot 8 kHz mono → 48 kHz 2-channel
    stereo (slot 0 → left, slot 1 → right), the reference's playback
    parity (src/core/audio/dsd_audio.c:798 upsample + dsd_audio2.c
    2-slot stereo variants).  Wraps a sink exposing
    ``write_frames([n, 2] float @48k)``.

    Slots arrive asynchronously; samples pair up when both slots have
    audio, and a slot running ahead of the other by more than
    ``skew`` output samples (default one 20 ms voice frame) flushes
    against silence so latency stays bounded."""

    def __init__(self, inner, skew: int = 960):
        self._inner = inner
        self._up = (StreamingUpsampler(), StreamingUpsampler())
        self._pend = [np.zeros(0, np.float32), np.zeros(0, np.float32)]
        self._skew = skew

    def _flush(self, force: bool = False) -> None:
        a, b = self._pend
        n = min(len(a), len(b))
        if n:
            frames = np.stack([a[:n], b[:n]], axis=1)
            self._inner.write_frames(frames)
            self._pend = [a[n:], b[n:]]
            a, b = self._pend
        for s in (0, 1):
            x = self._pend[s]
            excess = len(x) if force else len(x) - self._skew
            if excess > 0:
                frames = np.zeros((excess, 2), np.float32)
                frames[:, s] = x[:excess]
                self._inner.write_frames(frames)
                self._pend[s] = x[excess:]

    def write(self, slot: int, pcm: np.ndarray) -> None:
        s = slot & 1
        up = self._up[s](pcm)
        self._pend[s] = np.concatenate([self._pend[s], up])
        self._flush()

    def close(self) -> None:
        self._flush(force=True)
        self._inner.close()


def list_audio_devices(out=None) -> None:
    """-O: list playback endpoints.  Uses pactl when a Pulse server is
    reachable, otherwise reports which external players/backends the
    sink layer could use (reference dsd_audio_list_devices)."""
    import shutil
    import subprocess
    import sys
    out = out or sys.stdout
    if shutil.which("pactl"):
        for kind in ("sources", "sinks"):
            try:
                r = subprocess.run(["pactl", "list", "short", kind],
                                   capture_output=True, text=True,
                                   timeout=3)
                if r.returncode == 0:
                    print(f"pulse {kind}:", file=out)
                    print(r.stdout.rstrip() or "  (none)", file=out)
                    continue
            except Exception:
                pass
            print(f"pulse {kind}: unavailable", file=out)
        return
    print("no Pulse server; available output backends:", file=out)
    for cand in PlayerSink.DEFAULTS:
        name = cand.split()[0]
        mark = "found" if shutil.which(name) else "not on PATH"
        print(f"  play:{name} ({mark})", file=out)
    print("  wav:<path>  pcm:<path>  udp:<host:port>  null", file=out)


def make_sink(spec: str, float_audio: bool = False) -> AudioSink | None:
    """Parse a '-o' style sink spec: null | wav:P | wav2:P | pcm:P |
    udp:HOST:PORT | play[:command] | pulse | alsa[:device].  Returns
    None for unknown specs.  ``float_audio`` (-y) upgrades file sinks
    to 32-bit float output.

    Live playback sinks (play/pulse/alsa) run the reference's playback
    parity path — 8k→48k polyphase upsample + 2-slot stereo mix
    (UpmixSink).  The 8 kHz mono legacy forms stay available as
    play8[:cmd] / pulse8 / alsa8[:device]."""
    if spec == "null":
        return NullSink()
    if spec == "play" or spec.startswith("play:"):
        return UpmixSink(PlayerSink(
            spec[5:] if spec.startswith("play:") else "",
            rate=48000, channels=2))
    if spec == "play8" or spec.startswith("play8:"):
        return PlayerSink(spec[6:] if spec.startswith("play8:") else "")
    if spec == "pulse":
        return UpmixSink(PulseSimpleSink(rate=48000, channels=2))
    if spec == "pulse8":
        return PulseSimpleSink()
    if spec == "alsa" or spec.startswith("alsa:"):
        return UpmixSink(AlsaSink(
            device=spec[5:] or "default"
            if spec.startswith("alsa:") else "default",
            rate=48000, channels=2))
    if spec == "alsa8" or spec.startswith("alsa8:"):
        return AlsaSink(device=spec[6:] or "default"
                        if spec.startswith("alsa8:") else "default")
    if spec.startswith("wav2:"):
        return StereoWavSink(spec[5:])
    if spec.startswith("wav:"):
        return (FloatWavSink if float_audio else WavSink)(spec[4:])
    if spec.startswith("pcm:"):
        if float_audio:
            class _F32Pcm(PcmSink):
                def write(self, slot, pcm):
                    self._f.write(np.asarray(pcm, dtype="<f4").tobytes())
            return _F32Pcm(spec[4:])
        return PcmSink(spec[4:])
    if spec.startswith("udp:"):
        from dsdneo_tpu_torch.io.net import UdpAudioOutput
        host, _, port = spec[4:].rpartition(":")
        out = UdpAudioOutput(host or "127.0.0.1", int(port))

        class _UdpSink(AudioSink):
            def write(self, slot, pcm):
                out.write(pcm)

            def close(self):
                out.close()
        return _UdpSink()
    return None
