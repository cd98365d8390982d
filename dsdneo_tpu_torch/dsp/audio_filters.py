"""Decoded-audio conditioning: de-emphasis, DC block, audio low- and
high-pass, gain, and the 8 → 48 kHz playback upsampler.

Counterpart of ``dsdneo_tpu/dsp/audio_filters.py`` and of the CLI's
monitor-audio conditioning (``cli._condition_audio``).  Every filter is
the one-pole IIR ``y[n] = a·y[n−1] + (1−a)·x[n]`` over the last axis of a
``[R, T]`` float32 tensor, from a zero state, or from a carried state
that the call updates in place (successive blocks of the same rows then
come out as one call on their concatenation would): kernel K8
(``csrc/one_pole.cu``) on a CUDA tensor, :func:`one_pole_plain` on a
CPU tensor.  The coefficients are the JAX package's Python doubles;
``a`` enters the recurrence as float32 and ``1 − a`` is taken in double
and then rounded, as XLA folds the JAX function's constants; like XLA's
CPU backend, every step flushes subnormal values to zero (a silent
stretch decays the state into that range within ~500 steps).  The host
classes (:class:`AutoGain`, :class:`AudioGate`, :class:`AudioConcealer`)
are numpy copies.
"""

from __future__ import annotations

import numpy as np
import torch

from dsdneo_tpu_torch import kernels

DEEMPH_TAU_US = {"50": 50.0, "75": 75.0, "nfm": 750.0}
FLT_MIN = float(np.finfo(np.float32).tiny)      # least normal float32


def _coeffs(a: float) -> tuple[float, float]:
    """(float32 a, float32 (1 − a)) of a double ``a``, as Python floats."""
    return float(np.float32(a)), float(np.float32(1.0 - a))


def fma_f32_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
               ) -> torch.Tensor:
    """``a · b + c`` of float32 tensors, rounded once to float32 (a
    correctly rounded fused multiply-add).  The product is exact in
    float64; the float64 sum is rounded to odd (its exact error from the
    two-sum, and one step away from an even last bit when that error is
    not zero), which makes the final rounding to float32 the correct
    one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def _ftz(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` with subnormal values flushed to signed zero."""
    return torch.where(v.abs() < FLT_MIN, v * 0.0, v)


def one_pole_plain(x: torch.Tensor, a: float, diff: bool = False,
                   state: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of K8: a loop over the last axis of
    ``x`` [R, T] float32 in the kernel's form, ``y = fma(f32(a), y,
    f32(f32(1 − a) · x[n]))`` from ``y = 0``, or from ``state`` ([R]
    float32, which then takes the last ``y``), every input and result
    flushed to zero when subnormal; returns ``y``, or ``x − y`` when
    ``diff``."""
    af, bf = _coeffs(a)
    x = _ftz(x.to(torch.float32))
    bx = _ftz(x * torch.tensor(bf, dtype=torch.float32, device=x.device))
    a_t = torch.full(x.shape[:-1], af, dtype=torch.float32,
                     device=x.device)
    y = (torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
         if state is None else _ftz(state.to(torch.float32)))
    out = torch.empty_like(x)
    for n in range(x.shape[-1]):
        y = _ftz(fma_f32_rn(a_t, y, bx[..., n]))
        out[..., n] = y
    if state is not None and x.shape[-1]:
        state.copy_(y)
    return _ftz(x - out) if diff else out


def _one_pole_card(x: torch.Tensor, mode: int, a: float, a2: float = 0.0,
                   state: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K8 on ``x`` ``[R, T]`` float32 on the card: ``mode`` 0
    gives ``y``, 1 ``x − y``, 2 the cascade of pole ``a`` then pole
    ``a2``; ``state`` ([R, 2] float32 on the card: each row's ``y`` and
    the cascade's second filter's), when given, starts the filters and
    takes their last values.  Counts its launch on :func:`one_pole`."""
    if x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}: expected [R, T]")
    kernels.require(x, "x", torch.float32, contiguous=False)
    x = x.contiguous()
    R, T = x.shape
    if state is not None:
        kernels.require(state, "state", torch.float32)
        if tuple(state.shape) != (R, 2) or state.device != x.device:
            raise ValueError(f"state {tuple(state.shape)} on "
                             f"{state.device}: expected [{R}, 2] on "
                             f"{x.device}")
    out = torch.empty_like(x)
    if R and T:
        err = kernels.load().dsd_one_pole(
            x.data_ptr(), out.data_ptr(), R, T, *_coeffs(a), *_coeffs(a2),
            mode, None if state is None else state.data_ptr(),
            kernels.stream_handle(x))
        kernels.check(err, "one_pole")
        one_pole.launches += 1
    return out


def one_pole(x: torch.Tensor, a: float, diff: bool = False,
             state: torch.Tensor | None = None) -> torch.Tensor:
    """One-pole IIR over the last axis of ``x`` ``[R, T]`` float32: ``y``,
    or ``x − y`` when ``diff``, from ``state[:, 0]`` when a carried
    ``[R, 2]`` state is given.  A CUDA tensor launches kernel K8; a CPU
    tensor runs :func:`one_pole_plain`."""
    if x.device.type == "cpu":
        return one_pole_plain(x, a, diff,
                              None if state is None else state[:, 0])
    return _one_pole_card(x, int(diff), a, state=state)


one_pole.launches = 0


def one_pole_cascade(x: torch.Tensor, a: float, a2: float,
                     state: torch.Tensor | None = None) -> torch.Tensor:
    """The one-pole IIR of pole ``a`` and then that of pole ``a2`` over
    the last axis of ``x`` ``[R, T]`` float32, equal bit for bit to two
    :func:`one_pole` calls (from ``state[:, 0]`` and ``state[:, 1]``
    when a carried ``[R, 2]`` state is given).  A CUDA tensor launches
    kernel K8 once (both recurrences in one pass); a CPU tensor runs
    :func:`one_pole_plain` twice, its plain version."""
    if x.device.type == "cpu":
        if state is None:
            return one_pole_plain(one_pole_plain(x, a), a2)
        return one_pole_plain(one_pole_plain(x, a, state=state[:, 0]), a2,
                              state=state[:, 1])
    return _one_pole_card(x, 2, a, a2, state=state)


def deemphasis_pole(fs: float, tau_us: float) -> float:
    """The pole of the de-emphasis of time constant ``tau_us``."""
    return float(np.exp(-1.0 / (fs * tau_us * 1e-6)))


def lowpass_pole(fs: float, fc: float) -> float:
    """The pole of the one-pole low-pass of cutoff ``fc``."""
    return float(np.exp(-2.0 * np.pi * fc / fs))


def deemphasis(x: torch.Tensor, fs: float = 8000.0,
               tau_us: float = 750.0) -> torch.Tensor:
    """Standard NFM de-emphasis (750 µs by default)."""
    return one_pole(x, deemphasis_pole(fs, tau_us))


def dc_block(x: torch.Tensor, fs: float = 8000.0,
             fc: float = 30.0) -> torch.Tensor:
    """Remove slow DC wander: ``x − lowpass(x)``."""
    return one_pole(x, lowpass_pole(fs, fc), diff=True)


def audio_lpf(x: torch.Tensor, fs: float = 8000.0,
              fc: float = 3400.0) -> torch.Tensor:
    return one_pole(x, lowpass_pole(fs, fc))


def audio_hpf(x: torch.Tensor, fs: float = 8000.0,
              fc: float = 300.0) -> torch.Tensor:
    """``x − audio_lpf(x)``."""
    return one_pole(x, lowpass_pole(fs, fc), diff=True)


def condition_audio(pcm: torch.Tensor, deemph: str = "",
                    audio_lpf_hz: float = 0.0, gain: float = 0.0,
                    state: torch.Tensor | None = None) -> torch.Tensor:
    """The CLI's monitor-audio conditioning of decoded ``[C, T]`` 8 kHz
    PCM: the fixed output gain (``gain`` 0..50, 25 = unity) when it is
    positive, the ``DSD_NEO_DEEMPH`` de-emphasis (``"50"``, ``"75"`` or
    ``"nfm"``; ``""`` and ``"off"`` skip it) and the
    ``DSD_NEO_AUDIO_LPF`` one-pole low-pass when ``audio_lpf_hz`` is
    positive.  With both filters on, one :func:`one_pole_cascade` runs
    them.  ``state`` ([C, 2] float32 on ``pcm``'s device, zeros before
    the first block) carries the filters across successive blocks of the
    same rows."""
    pcm = pcm.to(torch.float32)
    if gain > 0:
        pcm = pcm * (gain / 25.0)
    tau = DEEMPH_TAU_US.get(deemph)
    poles = ([deemphasis_pole(8000.0, tau)] if tau is not None else []) \
        + ([lowpass_pole(8000.0, float(audio_lpf_hz))]
           if audio_lpf_hz > 0 else [])
    if len(poles) == 2:
        return one_pole_cascade(pcm, *poles, state=state)
    if poles:
        return one_pole(pcm, poles[0], state=state)
    return pcm


def upsample_8k_to_48k(pcm: torch.Tensor) -> torch.Tensor:
    """8 kHz voice → 48 kHz playback rate (reference dsd_audio.c
    upsample path), via the polyphase resampler, on ``pcm``'s device."""
    from dsdneo_tpu_torch.dsp.resampler import resample
    return resample(pcm, 8000, 48000)


class AutoGain:
    """Slow AGC for synthesized voice (reference gain.c auto mode)."""

    def __init__(self, target_rms: float = 0.15, max_gain: float = 40.0,
                 alpha: float = 0.2):
        self.gain = 1.0
        self.target = target_rms
        self.max_gain = max_gain
        self.alpha = alpha

    def apply(self, pcm: np.ndarray) -> np.ndarray:
        rms = float(np.sqrt(np.mean(np.square(pcm)) + 1e-12))
        want = min(self.target / max(rms, 1e-6), self.max_gain)
        self.gain += self.alpha * (want - self.gain)
        return np.clip(pcm * self.gain, -1.0, 1.0)


class AudioGate:
    """Squelch-style voice gate: opens when short-term RMS exceeds the
    open threshold, holds for ``hang_frames`` below the close threshold,
    then mutes.  Block-wise and bounded-state."""

    def __init__(self, open_rms: float = 0.01, close_rms: float = 0.004,
                 hang_frames: int = 8):
        self.open_rms = open_rms
        self.close_rms = close_rms
        self.hang_frames = hang_frames
        self.open = False
        self._below = 0

    def process(self, pcm: np.ndarray) -> np.ndarray:
        rms = float(np.sqrt(np.mean(np.square(pcm)))) if len(pcm) else 0.0
        if rms >= self.open_rms:
            self.open = True
            self._below = 0
        elif self.open and rms < self.close_rms:
            self._below += 1
            if self._below >= self.hang_frames:
                self.open = False
                self._below = 0
        return pcm if self.open else np.zeros_like(pcm)


class AudioConcealer:
    """Underrun concealment: fade-repeat of the last good buffer, −6 dB
    per consecutive underrun, silence after ``max_repeats``."""

    def __init__(self, max_repeats: int = 4, fade: float = 0.5):
        self.max_repeats = max_repeats
        self.fade = fade
        self._last: np.ndarray | None = None
        self._repeats = 0
        self.concealed = 0

    def feed(self, pcm: np.ndarray | None, n: int) -> np.ndarray:
        """pcm = the available buffer or None on underrun; always
        returns ``n`` samples."""
        if pcm is not None and len(pcm) >= n:
            self._last = np.asarray(pcm[:n], dtype=np.float32).copy()
            self._repeats = 0
            return self._last
        self.concealed += 1
        if self._last is None or self._repeats >= self.max_repeats:
            return np.zeros(n, dtype=np.float32)
        self._repeats += 1
        self._last = self._last * self.fade
        return self._last
