"""Device DSP over ``[C, N]`` blocks: the CU8 widen, the fs/4 rotation,
the channel FIRs, the halfband decimator, the FM discriminator, power and
the DC blocker.

Counterpart of ``dsdneo_tpu/dsp/frontend.py``.  ``fm_discriminate(
fir_complex(x, taps))`` is the plain version of kernel K1
(``ops.fir_discriminate``), which fuses the two on the card.  The rest
is plain PyTorch on whatever device its tensor lies.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def widen_cu8(raw: torch.Tensor) -> torch.Tensor:
    """uint8 interleaved I/Q ``[C, 2N]`` → complex64 ``[C, N]`` in about
    [-1, 1]: ``x · (1/127.5) − 1`` rounded once, as XLA contracts the JAX
    package's form into a fused multiply-add (the fleet's row extractor
    widens with ``(x − 127.5) · (1/127.5)`` instead)."""
    from dsdneo_tpu_torch.vocoder.synth import fma_f32
    one = torch.ones((), device=raw.device)
    x = fma_f32(raw.to(torch.float32), one / 127.5, -one)
    return torch.complex(x[..., 0::2].contiguous(), x[..., 1::2].contiguous())


def fs4_rotate(x: torch.Tensor, sign: int = 1) -> torch.Tensor:
    """Multiply complex ``[..., N]`` by exp(±jπn/2): a spectrum shift of
    fs/4 (each factor is 1, ±j or −1, so only signs and swaps)."""
    n = x.shape[-1]
    rot = torch.tensor([1, 1j * sign, -1, -1j * sign], dtype=torch.complex64,
                       device=x.device)
    return x * rot.repeat((n + 3) // 4)[:n]


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


def fir_real(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Real FIR over ``[C, N]`` (same length, zero group delay)."""
    return _fir_real(x, taps)


def decimate2_halfband(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Filter and decimate by 2: complex ``[C, N]`` → ``[C, ceil(N/2)]``
    (``fir_complex``, then every second sample from the first)."""
    return fir_complex(x, taps)[:, ::2]


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


def dc_block(x: torch.Tensor) -> torch.Tensor:
    """Remove each row's complex mean from complex ``[C, N]``; the mean is
    summed in XLA's order (``vocoder.synth.tree_sum``) and scaled by
    float32 1/N, as XLA turns ``jnp.mean``'s division into a product."""
    from dsdneo_tpu_torch.vocoder.synth import tree_sum
    inv = torch.tensor(1.0 / x.shape[-1], dtype=torch.float32,
                       device=x.device)
    mean = torch.complex(tree_sum(x.real.contiguous()) * inv,
                         tree_sum(x.imag.contiguous()) * inv)
    return x - mean[..., None]
