"""The plain wideband channelizer the benchmark holds the port to.

A frozen copy of the port's plain paths at commit
1acf1f855b4962341c6932295300c03c25b32489: ``dsp/firdes.py``
(``_window``, ``lowpass_taps``), ``dsp/channelizer.py``
(``prototype_taps``, ``_branch_fir``, ``channelize``, ``channelize_os2``),
``engine/fleettrunk.py`` (``halfband_taps``), ``dsp/frontend.py``
(``decimate2_halfband``) and ``engine/wideband.py``
(``_complex_on``, ``channelize_band_device``).  It imports nothing of
the port.  With ``tf32`` the branch FIR and the halfband round their
inputs to TF32, the control's precision.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from portbench.reference.p25_chain import P25Chain, to_tf32


def _window(kind: str, n: int) -> np.ndarray:
    m = np.arange(n)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * m / (n - 1))
    if kind == "blackman-harris":
        return (0.35875 - 0.48829 * np.cos(2 * np.pi * m / (n - 1))
                + 0.14128 * np.cos(4 * np.pi * m / (n - 1))
                - 0.01168 * np.cos(6 * np.pi * m / (n - 1)))
    raise ValueError(f"unknown window {kind!r}")


def lowpass_taps(ntaps: int, fs: float, cutoff: float,
                 window: str = "hamming") -> np.ndarray:
    if ntaps % 2 == 0:
        ntaps += 1
    m = np.arange(ntaps) - (ntaps - 1) / 2
    fc = cutoff / fs
    h = np.sinc(2 * fc * m) * 2 * fc
    h *= _window(window, ntaps)
    h /= np.sum(h)
    return h.astype(np.float32)


@lru_cache(maxsize=8)
def prototype_taps(n_ch: int, taps_per_branch: int = 8,
                   cutoff: float = 0.5) -> np.ndarray:
    ntaps = n_ch * taps_per_branch
    h = lowpass_taps(ntaps - 1, float(n_ch), cutoff,
                     window="blackman-harris")
    out = np.zeros(ntaps, dtype=np.float32)
    out[:h.shape[0]] = h
    return out * n_ch


def halfband_taps() -> np.ndarray:
    return lowpass_taps(62, 2.0, 0.5, window="blackman-harris"
                        ).astype(np.float32)


def _branch_fir(plane, hp, m, tf32):
    P = hp.shape[0]
    if tf32:
        plane, hp = to_tf32(plane), to_tf32(hp)
    xpad = torch.nn.functional.pad(plane, (0, 0, P - 1, 0))
    y = torch.zeros_like(plane)
    for p in range(P):
        y = y + xpad[..., P - 1 - p:P - 1 - p + m, :] * hp[p]
    return y


def channelize(x, n_ch, taps_per_branch=8, cutoff=0.5, tf32=False):
    h = prototype_taps(n_ch, taps_per_branch, cutoff)
    P = taps_per_branch
    m = x.shape[-1] // n_ch
    xp = x[..., :m * n_ch].reshape(*x.shape[:-1], m, n_ch)
    hp = torch.as_tensor(h.reshape(P, n_ch), device=x.device)
    y = torch.complex(_branch_fir(xp.real, hp, m, tf32),
                      _branch_fir(xp.imag, hp, m, tf32))
    ch = torch.fft.fft(y, dim=-1)
    return ch.movedim(-1, -2).to(torch.complex64)


def channelize_os2(x, n_ch, taps_per_branch=12, cutoff=0.5, tf32=False):
    d = n_ch // 2
    m = (x.shape[-1] - d) // n_ch
    n = m * n_ch
    s0 = channelize(x[..., :n], n_ch, taps_per_branch, cutoff, tf32)
    s1 = channelize(x[..., d:d + n], n_ch, taps_per_branch, cutoff, tf32)
    sign = torch.ones(n_ch, dtype=torch.complex64, device=x.device)
    sign[1::2] = -1.0
    s1 = s1 * sign[:, None]
    return torch.stack([s0, s1], dim=-1).reshape(*s0.shape[:-1], 2 * m)


def channelize_band(band: torch.Tensor, n_ch: int, chain: P25Chain
                    ) -> torch.Tensor:
    """A ``[B, 2]`` float32 band (host or device) → the ``[n_ch, B', 2]``
    float32 48 kHz basebands on ``chain``'s device: the 2x-oversampled
    bank (12 taps a branch), then the 63-tap halfband and every second
    sample."""
    x = band.to(chain.device)
    x = torch.complex(x[..., 0].contiguous(), x[..., 1].contiguous())
    ch2 = channelize_os2(x.to(torch.complex64), n_ch, taps_per_branch=12,
                         tf32=chain.tf32)
    hb = torch.as_tensor(halfband_taps(), device=chain.device)
    ch = chain.fir_complex(ch2, hb)[:, ::2].contiguous()
    return torch.view_as_real(ch)
