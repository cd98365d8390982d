"""CQPSK / LSM (π/4-DQPSK) demodulation, feed-forward.

Counterpart of ``dsdneo_tpu/dsp/cqpsk.py`` (``estimate_cfo_qpsk``,
``estimate_cfo_qpsk_windowed``, ``demod_cqpsk``):

  1. carrier: the spectral line of x⁴ gives the offset in one FFT;
  2. matched filter: root-raised cosine (``dsp.frontend.fir_complex``,
     full float32 on the card);
  3. timing: windowed Oerder & Meyr on the squared envelope
     (``symbols.timing.decision_positions``);
  4. the differential phasor s_k · conj(s_{k-1}), whose angle is the
     symbol: ±45° = ±1, ±135° = ±3.

Plain PyTorch on complex64 ``[C, N]``; the JAX package computes all of it
outside any Pallas kernel.  Where a float32 phase reaches thousands of
radians the order of the products decides the rounding, so the port
keeps the order XLA gives them inside ``jit`` (constants folded, a
division by a constant as a product with its reciprocal).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.dsp.frontend import fir_complex
from dsdneo_tpu_torch.symbols.timing import decision_positions, interp
from dsdneo_tpu_torch.vocoder.synth import blocked_cumsum


def _rotate(x: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """``x · e^{i·phase}`` for a real float32 phase."""
    return x * torch.complex(torch.cos(phase), torch.sin(phase))


def estimate_cfo_qpsk(x: torch.Tensor, fs: float, symbol_rate: float,
                      pull_in_hz: float = 0.0) -> torch.Tensor:
    """Carrier offset per channel by the 4th-power method: ``[C]`` Hz.

    π/4-DQPSK phase steps are odd multiples of π/4, so x⁴ flips by π
    every symbol and its line sits at 4·CFO + symbol_rate/2.  The search
    is always bounded to CFO within ±``pull_in_hz`` (±symbol_rate/8 when
    0), which keeps the mirror line at 4·CFO − symbol_rate/2 out; the
    strongest bin wins, the lower one of equal bins."""
    x2 = x * x
    x4 = x2 * x2                # not pow(): that goes through log and exp
    n = x.shape[-1]
    spec = torch.fft.fft(x4, dim=-1).abs()
    i = torch.arange(n, dtype=torch.float32, device=x.device)
    k = torch.remainder(i + n // 2, n) - n // 2
    freqs = k * float(np.float32(1.0) / np.float32((1.0 / fs) * n))
    pi_hz = pull_in_hz if pull_in_hz > 0 else symbol_rate / 8.0
    mask = (freqs - symbol_rate / 2.0).abs() <= 4.0 * pi_hz
    spec = torch.where(mask[None, :], spec, 0.0)
    kmax = torch.argmax(spec, dim=-1)
    return (freqs[kmax] - symbol_rate / 2.0) * 0.25


def estimate_cfo_qpsk_windowed(x: torch.Tensor, fs: float,
                               symbol_rate: float, n_windows: int,
                               pull_in_hz: float = 0.0) -> torch.Tensor:
    """Per-window 4th-power estimates ``[C, W]`` Hz at the centres of
    ``n_windows`` equal slices of the block: short windows keep a
    drifting carrier's smear inside one bin."""
    c, n = x.shape
    w = n // n_windows
    xw = x[:, :w * n_windows].reshape(c * n_windows, w)
    cfo = estimate_cfo_qpsk(xw, fs, symbol_rate, pull_in_hz=pull_in_hz)
    return cfo.reshape(c, n_windows)


def demod_cqpsk(x: torch.Tensor, fs: float, symbol_rate: float,
                rrc_alpha: float = 0.2, n_sym: int | None = None,
                ted_gain: float = 1.0, pull_in_hz: float = 0.0,
                cfo_prior: float | None = None, cfo_alpha: float = 1.0,
                cfo_windows: int = 1):
    """Complex64 ``[C, N]`` baseband → (soft symbols ``[C, K]`` in the
    ±1/±3 alphabet, carrier offsets ``[C]`` Hz).

    ``ted_gain`` shortens (> 1) or lengthens the timing windows;
    ``cfo_prior`` with ``cfo_alpha`` < 1 blends the estimate with a
    carried one; ``cfo_windows`` > 1 estimates the carrier per window and
    de-rotates along the interpolated, integrated trajectory."""
    c, n = x.shape
    dev = x.device
    sps = fs / symbol_rate
    if n_sym is None:
        n_sym = int((n - 2 * sps) // sps) - 1
    f32 = lambda v: float(np.float32(v))
    tidx = torch.arange(n, dtype=torch.float32, device=dev)

    # 1. carrier offset and de-rotation
    if cfo_windows > 1:
        cfo_w = estimate_cfo_qpsk_windowed(x, fs, symbol_rate, cfo_windows,
                                           pull_in_hz=pull_in_hz)
        if cfo_prior is not None and cfo_alpha < 1.0:
            cfo_w = cfo_alpha * cfo_w + (1.0 - cfo_alpha) * cfo_prior
        w = n // cfo_windows
        centers = (torch.arange(cfo_windows, dtype=torch.float32, device=dev)
                   + 0.5) * w
        cfo_t = interp(tidx, centers, cfo_w)
        # the integrated phase stays continuous at the window seams; the
        # sum runs to ~10^7, so it is taken in the JAX package's order
        phase = blocked_cumsum(cfo_t) * f32(2.0 * math.pi / fs)
        x = _rotate(x, -phase)
        cfo = cfo_w.mean(dim=-1)
    else:
        cfo = estimate_cfo_qpsk(x, fs, symbol_rate, pull_in_hz=pull_in_hz)
        if cfo_prior is not None and cfo_alpha < 1.0:
            cfo = cfo_alpha * cfo + (1.0 - cfo_alpha) * cfo_prior
        t = tidx * f32(1.0 / fs)
        x = _rotate(x, (cfo * f32(-2.0 * math.pi))[:, None] * t[None, :])

    # 2. matched filter
    taps = torch.as_tensor(firdes.rrc(sps, int(8 * sps) | 1, rrc_alpha),
                           device=dev)
    y = fir_complex(x, taps)

    # 3. timing from the squared envelope, symbols by linear interpolation
    e = y.abs() ** 2
    win = 128
    if ted_gain != 1.0:
        win = int(np.clip(round(128.0 / max(ted_gain, 1e-3)), 32, 512))
    pos = decision_positions(e, sps, win_symbols=win, max_symbols=n_sym + 1)
    i0 = torch.floor(pos).to(torch.int64)
    frac = (pos - i0.to(torch.float32))[..., None]
    yr = torch.view_as_real(y)                               # [C, N, 2]
    g0 = torch.gather(yr, 1, i0[..., None].expand(-1, -1, 2))
    g1 = torch.gather(yr, 1, (i0 + 1)[..., None].expand(-1, -1, 2))
    s = torch.view_as_complex((g0 * (1 - frac) + g1 * frac).contiguous())

    # 4. differential phasor → soft symbols
    d = s[:, 1:] * s[:, :-1].conj()
    soft = torch.atan2(d.imag, d.real) * f32(4.0 / math.pi)
    return soft, cfo
