"""Feed-forward symbol timing: windowed Oerder & Meyr with drift unwrap.

Counterpart of ``_unwrap_mod`` and ``decision_positions`` in
``dsdneo_tpu/symbols/timing.py``, plus :func:`interp`, which PyTorch
lacks, in ``jnp.interp``'s own form.  Constants are folded the way XLA
folds them when the JAX package runs these inside ``jit`` (as its
pipelines do): the tone's phase is ``n · f32(-2π/sps)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsdneo_tpu_torch.dsp.frontend import floor_mod
from dsdneo_tpu_torch.vocoder.synth import fma_f32


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """Piecewise-linear interpolation of ``fp [C, W]`` given at the
    increasing points ``xp [W]``, read at ``x [K]`` → ``[C, K]``; outside
    ``xp`` the end values hold.  ``jnp.interp`` mapped over rows: the
    segment is the one right of ``x`` (``searchsorted`` from the right),
    and the value ``fp[i-1] + (x - xp[i-1]) / dx · df``, rounded once."""
    W = xp.shape[0]
    i = torch.searchsorted(xp, x, right=True).clamp(min=1).clamp(max=W - 1)
    lo = (i - 1) % W                       # W == 1: both ends are point 0
    dx = xp[i] - xp[lo]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    slope = (x - xp[lo]) / torch.where(dx0, torch.ones_like(dx), dx)
    # XLA contracts the product and the sum into one fused multiply-add
    f = torch.where(dx0, fp[:, lo],
                    fma_f32(slope.expand(fp.shape[0], -1),
                            fp[:, i] - fp[:, lo], fp[:, lo]))
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


def _unwrap_mod(tau: torch.Tensor, period: float) -> torch.Tensor:
    """Unwrap a sequence defined modulo ``period`` along the last axis."""
    d = floor_mod(torch.diff(tau, dim=-1) + period / 2, period) - period / 2
    return torch.cat([tau[..., :1], tau[..., :1] + torch.cumsum(d, dim=-1)],
                     dim=-1)


def decision_positions(e: torch.Tensor, sps: float, win_symbols: int = 256,
                       max_symbols: int | None = None) -> torch.Tensor:
    """Per-symbol decision instants ``[C, K]`` from a non-negative
    timing-energy signal ``[C, N]``: the phase of the symbol-rate line
    per window of ``win_symbols`` symbols, unwrapped across windows and
    interpolated to every symbol's nominal position."""
    c, n = e.shape
    dev = e.device
    L = max(int(round(win_symbols * sps)), 8)
    nw = max(n // L, 1)
    idx = torch.arange(n, dtype=torch.float32, device=dev)
    ang = idx * float(np.float32(-2.0 * math.pi / sps))
    m = min(nw * L, n)
    er = e[:, :m]
    Xr = torch.sum((er * torch.cos(ang[:m])).reshape(c, nw, -1), dim=-1)
    Xi = torch.sum((er * torch.sin(ang[:m])).reshape(c, nw, -1), dim=-1)
    tau = floor_mod(-torch.atan2(Xi, Xr) * (sps / (2 * math.pi)), sps)
    tau = _unwrap_mod(tau, sps)
    centers = (torch.arange(nw, dtype=torch.float32, device=dev) + 0.5) * L
    K = max_symbols if max_symbols is not None else int((n - 2 * sps) // sps)
    base = torch.arange(K, dtype=torch.float32, device=dev) * sps
    return torch.clamp(base[None, :] + interp(base, centers, tau),
                       0.0, n - 2.0)
