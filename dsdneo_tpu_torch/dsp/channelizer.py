"""Polyphase filter-bank channelizer: wideband I/Q → N channel basebands.

Counterpart of ``dsdneo_tpu/dsp/channelizer.py``.  One wideband block
splits into N channels in one pass:

    polyphase decompose [B] → [B/N, N] → a P-tap FIR per branch along the
    block axis → an FFT across the branches → [N, B/N] basebands.

Plain PyTorch on the tensor's device (shifted multiply-adds and
``torch.fft.fft``); the JAX package computes it outside any Pallas
kernel, so no hand kernel stands behind it.  The multiply-adds run in
the JAX loop's order, the real and imaginary planes apart; the FFT is
PyTorch's, which rounds differently from XLA's (the tests state the
bound).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from dsdneo_tpu_torch.dsp import firdes


@lru_cache(maxsize=8)
def prototype_taps(n_ch: int, taps_per_branch: int = 8,
                   cutoff: float = 0.5) -> np.ndarray:
    """Prototype low-pass of an N-channel bank, ``n_ch · taps_per_branch``
    float32 taps with gain N.  ``cutoff`` is in channel spacings: 0.5 for
    critical sampling; the 2x-oversampled bank may widen it, since its bin
    rate carries ±1 spacing faithfully."""
    ntaps = n_ch * taps_per_branch
    h = firdes.lowpass_taps(ntaps - 1, float(n_ch), cutoff,
                            window="blackman-harris")
    out = np.zeros(ntaps, dtype=np.float32)
    out[:h.shape[0]] = h
    return out * n_ch


@lru_cache(maxsize=16)
def _branch_taps(n_ch: int, taps_per_branch: int, cutoff: float,
                 device) -> torch.Tensor:
    """The prototype's taps as ``[P, n_ch]`` branch rows on ``device``,
    made once per device."""
    h = prototype_taps(n_ch, taps_per_branch, cutoff)
    return torch.as_tensor(h.reshape(taps_per_branch, n_ch), device=device)


def _branch_fir(plane: torch.Tensor, hp: torch.Tensor, m: int
                ) -> torch.Tensor:
    """``y[t, i] = Σ_p hp[p, i] · plane[t − p, i]`` over ``[..., m, N]``
    with zeros before the block, summed p = 0, 1, …, P−1."""
    P = hp.shape[0]
    xpad = torch.nn.functional.pad(plane, (0, 0, P - 1, 0))
    y = torch.zeros_like(plane)
    for p in range(P):
        y = y + xpad[..., P - 1 - p:P - 1 - p + m, :] * hp[p]
    return y


def channelize(x: torch.Tensor, n_ch: int, taps_per_branch: int = 8,
               cutoff: float = 0.5) -> torch.Tensor:
    """Complex ``[..., B]`` → complex64 ``[..., n_ch, B // n_ch]``: the
    critically sampled DFT bank, channel k centred at k·fs/n_ch (past
    n_ch/2 wrapping to negative frequencies)."""
    m = x.shape[-1] // n_ch
    xp = x[..., :m * n_ch].reshape(*x.shape[:-1], m, n_ch)
    hp = _branch_taps(n_ch, taps_per_branch, cutoff, x.device)
    y = torch.complex(_branch_fir(xp.real, hp, m),
                      _branch_fir(xp.imag, hp, m))
    ch = torch.fft.fft(y, dim=-1)                      # [..., m, n_ch]
    return ch.movedim(-1, -2).to(torch.complex64)


def channelize_os2(x: torch.Tensor, n_ch: int, taps_per_branch: int = 12,
                   cutoff: float = 0.5) -> torch.Tensor:
    """2x-oversampled bank: complex ``[..., B]`` → ``[..., n_ch, 2m]``,
    m = (B − n_ch/2) // n_ch.  The bank runs twice, half a stride apart;
    the second's odd bins are negated (an N/2 shift is e^{−jπk} in bin
    k) and the two interleave, so each channel comes out at twice the
    spacing rate."""
    d = n_ch // 2
    m = (x.shape[-1] - d) // n_ch
    n = m * n_ch
    s0 = channelize(x[..., :n], n_ch, taps_per_branch, cutoff)
    s1 = channelize(x[..., d:d + n], n_ch, taps_per_branch, cutoff)
    sign = torch.ones(n_ch, dtype=torch.complex64, device=x.device)
    sign[1::2] = -1.0
    s1 = s1 * sign[:, None]
    return torch.stack([s0, s1], dim=-1).reshape(*s0.shape[:-1], 2 * m)


def channel_frequencies(n_ch: int, fs: float) -> np.ndarray:
    """Centre frequency of each channel of the bank (Hz, signed)."""
    k = np.arange(n_ch)
    k = np.where(k <= n_ch // 2, k, k - n_ch)
    return k * (fs / n_ch)
