"""Rational L/M polyphase resampler (upfirdn) in PyTorch.

Counterpart of ``_plan`` and ``resample`` in
``dsdneo_tpu/dsp/resampler.py`` (reference parity: src/dsp/resampler.cpp,
the polyphase plan held in demod_state.h:166-183).  Output sample k sits
at input position k·M/L: its integer part ``ipos`` picks a window of
P = 12 input samples and its remainder ``phase`` one of the bank's L
phases, and y[k] = Σ_p bank[phase_k, p] · x[ipos_k − p].  It runs where
the input tensor lies, in plain PyTorch (a gather and multiply-adds; no
device loop, no kernel).  The taps are added in order p = 0, 1, …, P−1
in float32, the real and imaginary parts apart, as the JAX function's
``jnp.sum`` of the ``[K, P]`` window times the bank adds them on the
CPU, so both packages give the same samples bit for bit there.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch

from dsdneo_tpu_torch.dsp import firdes


@lru_cache(maxsize=32)
def _plan(l: int, m: int, taps_per_phase: int = 12) -> np.ndarray:
    """``[L, P]`` float32 polyphase bank: a Blackman-Harris low-pass of
    L·P − 1 taps at 0.5 / max(L, M) of the input rate, gain L."""
    ntaps = l * taps_per_phase
    cutoff = 0.5 / max(l, m)
    h = firdes.lowpass_taps(ntaps - 1, 1.0, cutoff, window="blackman-harris")
    hp = np.zeros(l * taps_per_phase, dtype=np.float32)
    hp[:h.shape[0]] = h * l
    return hp.reshape(taps_per_phase, l).T.copy()   # [L phases, taps]


def _fir_sum(xpad: torch.Tensor, idx: torch.Tensor,
             coeffs: torch.Tensor) -> torch.Tensor:
    """Σ_p ``xpad[..., idx[:, p]] · coeffs[:, p]`` over p in order
    (float32; each product rounded, then added)."""
    acc = xpad[..., idx[:, 0]] * coeffs[:, 0]
    for p in range(1, idx.shape[1]):
        acc = acc + xpad[..., idx[:, p]] * coeffs[:, p]
    return acc


def resample(x: torch.Tensor, rate_in: int, rate_out: int,
             taps_per_phase: int = 12) -> torch.Tensor:
    """Resample ``[..., N]`` float32 or complex64 ``x`` from ``rate_in``
    to ``rate_out`` Hz on ``x``'s device: ``[..., N·L // M]``."""
    g = gcd(rate_in, rate_out)
    l, m = rate_out // g, rate_in // g
    if l == 1 and m == 1:
        return x
    dev = x.device
    bank = torch.as_tensor(_plan(l, m, taps_per_phase), device=dev)
    P = bank.shape[1]
    k_out = (x.shape[-1] * l) // m
    t = torch.arange(k_out, device=dev, dtype=torch.int64)
    ipos = (t * m) // l
    phase = (t * m) % l
    pad = P - 1
    # x[j] lives at xpad[j + pad]
    idx = ipos[:, None] - torch.arange(P, device=dev)[None, :] + pad
    coeffs = bank[phase]                                  # [K, P]
    if x.is_complex():
        xpad = torch.nn.functional.pad(torch.view_as_real(x),
                                       (0, 0, pad, 0))
        return torch.complex(_fir_sum(xpad[..., 0], idx, coeffs),
                             _fir_sum(xpad[..., 1], idx, coeffs))
    return _fir_sum(torch.nn.functional.pad(x, (pad, 0)), idx, coeffs)
