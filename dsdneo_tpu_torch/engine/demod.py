"""The power-gated front end of the bursty protocols: I/Q → dibits.

Counterpart of ``gated_frontend_step`` in ``dsdneo_tpu/engine/demod.py``,
the front end of D-STAR and M17 (and of YSF, dPMR and the EDACS monitor
in the JAX package): the channel FIR (``dsp.frontend.fir_complex``, full
float32 on the card too), the FM discriminator, a power gate that zeroes
the discriminator where ``|y|²`` of the filtered signal is under 2% of
the block's peak (dead air gives full-scale random angles that would
poison the timing and level estimates), the windowed O&M timing
(``symbols.timing.recover_symbols``) and the windowed-quantile slicer
(``symbols.slicer.slice_dibits``, ``win=512``).

Kernel K1 does not serve here: the gate needs ``|y|²`` of the filtered
signal, which K1 does not output, and the JAX function does not call
its Pallas kernel either.  This stage is plain PyTorch on either device.
"""

from __future__ import annotations

import torch

from dsdneo_tpu_torch.dsp.frontend import fir_complex, fm_discriminate
from dsdneo_tpu_torch.symbols import slicer, timing

GATE = 0.02                 # fraction of the block's peak power kept


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (PyTorch's vectorized CPU
    ``sqrt`` is not; its CUDA one is)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def power(y: torch.Tensor) -> torch.Tensor:
    """``jnp.abs(y) ** 2`` of complex ``[C, N]`` as XLA computes it: the
    modulus as ``max · sqrt(fma(r, r, 1))`` with ``r = min / max`` of
    the parts' magnitudes (the modulus of 0 is 0), then squared.  Not
    ``re² + im²``, which rounds otherwise; samples on the 2% edge decide
    the gate, so the form matters."""
    a, b = y.real.abs(), y.imag.abs()
    mx, mn = torch.maximum(a, b), torch.minimum(a, b)
    r = mn / mx
    m = mx * _sqrt_rn((r.double() * r.double() + 1.0).float())
    m = torch.where(torch.isnan(m), mn, m)
    return m * m


def gate_mask(y: torch.Tensor) -> torch.Tensor:
    """``[C, N]`` bool: the samples of filtered ``y`` whose power exceeds
    2% of its channel's peak."""
    p = power(y)
    return p > GATE * torch.amax(p, dim=-1, keepdim=True)


def gated_frontend_step(iq: torch.Tensor, taps: torch.Tensor, sps: float,
                        n_sym: int, four_level: bool = True):
    """``[C, B, 2]`` float32 I/Q planes → (dibits ``[C, n_sym]`` uint8,
    soft symbols ``[C, n_sym]`` float32, normalized to ±3)."""
    y = fir_complex(torch.complex(iq[..., 0], iq[..., 1]), taps)
    d = torch.where(gate_mask(y), fm_discriminate(y), 0.0)
    sym, _pos = timing.recover_symbols(d, sps, win_symbols=256,
                                       max_symbols=n_sym)
    return slicer.slice_dibits(sym, win=512, four_level=four_level)
