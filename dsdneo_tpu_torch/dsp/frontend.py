"""Channel FIR, FM discriminator and power over ``[C, N]`` blocks.

Counterpart of ``dsdneo_tpu/dsp/frontend.py``.  ``fm_discriminate(
fir_complex(x, taps))`` is the plain version of kernel K1
(``ops.fir_discriminate``), which fuses the two on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _fir_real(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """'Same'-aligned FIR of real ``[C, N]`` with 1-D taps (group delay
    removed): ``y[n] = sum_t taps[t] x[n + T//2 - t]``, zero padded.
    Full float32 on the card too: cuDNN's TF32 convolutions are switched
    off around the call, whatever the process has set."""
    t = taps.shape[0]
    left = (t - 1) // 2
    xp = F.pad(x[:, None, :], (left, t - 1 - left))
    w = taps.flip(0).to(x.dtype)[None, None, :]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv1d(xp, w)[:, 0, :]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def fir_complex(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Complex FIR with real taps over complex ``[C, N]`` (same length,
    zero delay), in full float32 on either device."""
    return torch.complex(_fir_real(x.real.contiguous(), taps),
                         _fir_real(x.imag.contiguous(), taps))


def fm_discriminate(x: torch.Tensor) -> torch.Tensor:
    """Quadrature FM discriminator over complex ``[C, N]``:
    ``angle(x[n] conj x[n-1]) / pi``; the first output compares the
    first sample with itself, so it is 0."""
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    p = x * prev.conj()
    return torch.atan2(p.imag, p.real) * (1.0 / math.pi)


def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """Floor modulo as ``jnp.mod`` computes it: an exact ``fmod``, then
    negative remainders moved up by ``m``."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def iq_power(x: torch.Tensor) -> torch.Tensor:
    """Mean power per channel ``[C]`` of complex ``[C, N]``."""
    return torch.mean(x.abs() ** 2, dim=-1)
