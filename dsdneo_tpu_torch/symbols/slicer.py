"""Symbol level estimation and dibit slicing over windows of symbols.

Counterpart of ``estimate_levels`` and ``slice_dibits`` in
``dsdneo_tpu/symbols/slicer.py``: per window of ``win`` symbols the 2%
and 98% quantiles give the centre and the outer level, and every symbol
of the window is sliced against them.  Dibit convention (the DSD
alphabet): +3 → 1, +1 → 0, −1 → 2, −3 → 3.

The quantile is ``jnp.quantile``'s ``linear`` method written out, not
``torch.quantile`` (which interpolates with ``lerp``, rounds otherwise,
and refuses more than 2^24 elements): the window sorted, the two order
statistics around ``q·(n−1)`` gathered, and ``low·(1−w) + high·w`` with
``w = q·(n−1) − floor(q·(n−1))`` in float32, its first product fused
into the sum as XLA's CPU backend contracts it.  The result is the JAX
function's inside ``jax.jit``, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from dsdneo_tpu_torch.engine.batched import slice_four_level
from dsdneo_tpu_torch.vocoder.synth import fma_f32


def _quantile_sorted(srt: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of each row of ``srt`` (sorted on its last
    axis), in ``jnp.quantile``'s float32 arithmetic."""
    n = srt.shape[-1]
    qn = np.float32(q) * np.float32(n - 1)
    lo, hi = int(np.floor(qn)), int(np.ceil(qn))
    hw = np.float32(qn - np.float32(lo))
    lw = np.float32(1.0) - hw
    return fma_f32(srt[..., lo], srt.new_tensor(float(lw)),
                   srt[..., hi] * float(hw))


def estimate_levels(sym: torch.Tensor, win: int = 512):
    """Per-window (centre, scale) of ``[C, K]`` soft symbols, expanded to
    ``[C, K]`` (a step per window; the tail past the last whole window
    takes the last window's values; a capture shorter than ``win`` is
    one window).  ``scale`` is the outer level's distance from the
    centre, at least 1e-6."""
    c, k = sym.shape
    win = min(win, k)
    nw = max(k // win, 1)
    srt = torch.sort(sym[:, :nw * win].reshape(c, nw, win), dim=-1).values
    hi = _quantile_sorted(srt, 0.98)
    lo = _quantile_sorted(srt, 0.02)
    center = (hi + lo) * 0.5
    scale = torch.clamp((hi - lo) * 0.5, min=1e-6)
    pad = k - nw * win
    center = torch.cat([torch.repeat_interleave(center, win, dim=-1),
                        center[:, -1:].expand(c, pad)], dim=-1)
    scale = torch.cat([torch.repeat_interleave(scale, win, dim=-1),
                       scale[:, -1:].expand(c, pad)], dim=-1)
    return center, scale


def slice_dibits(sym: torch.Tensor, win: int = 512, four_level: bool = True):
    """``[C, K]`` soft symbols → (dibits ``[C, K]`` uint8, the symbols
    normalized so the outer level is ±3).  Four levels: thresholds at 0
    and ±2; two levels (D-STAR): ``norm < 0`` → 3, else 1."""
    center, scale = estimate_levels(sym, win)
    norm = (sym - center) / scale * 3.0
    if four_level:
        return slice_four_level(norm), norm
    return torch.where(norm < 0.0, 3, 1).to(torch.uint8), norm
