"""Feed-forward symbol timing: windowed Oerder & Meyr with drift unwrap.

Counterpart of ``_unwrap_mod``, ``decision_positions`` and
``recover_symbols`` in ``dsdneo_tpu/symbols/timing.py``, plus
:func:`interp`, which PyTorch lacks, in ``jnp.interp``'s own form.  The
arithmetic is XLA's when the JAX package runs these inside ``jit`` (as
its pipelines do), so the CPU path is bit-identical to it:

  - the tone's phase is ``n · f32(-2π/sps)`` (a folded constant), the
    mean a sum times ``f32(1/n)``;
  - the window sums and the mean are taken in XLA's order
    (``vocoder.synth.tree_sum``), the unwrap's cumulative sum too
    (``vocoder.synth.blocked_cumsum``);
  - on the CPU, cos, sin and atan2 are the C library's float32 functions,
    which XLA's CPU backend calls (``csrc/libm_f32.cpp``); on the card
    PyTorch's;
  - the final lerp is contracted into a fused multiply-add.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsdneo_tpu_torch import kernels
from dsdneo_tpu_torch.dsp.frontend import floor_mod
from dsdneo_tpu_torch.vocoder.synth import blocked_cumsum, fma_f32, tree_sum


def _host_libm(name: str, *xs: torch.Tensor) -> torch.Tensor:
    """The C library's float32 ``name`` (``cosf``, ``sinf``, ``atan2f``)
    over CPU tensors of one shape."""
    xs = [x.to(torch.float32).contiguous() for x in xs]
    out = torch.empty_like(xs[0])
    getattr(kernels.load_host(), f"dsd_{name}")(
        *(x.data_ptr() for x in xs), out.data_ptr(), out.numel())
    return out


def cos_sin(ang: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of float32 angles, as ``jnp.cos`` / ``jnp.sin`` give
    them on the CPU (the C library's ``cosf`` / ``sinf``); on the card
    PyTorch's."""
    if ang.device.type == "cpu":
        return _host_libm("cosf", ang), _host_libm("sinf", ang)
    return torch.cos(ang), torch.sin(ang)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jnp.arctan2`` on float32: the C library's ``atan2f`` on the
    CPU, PyTorch's on the card."""
    if y.device.type == "cpu":
        return _host_libm("atan2f", y, x)
    return torch.atan2(y, x)


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
    if tau.shape[-1] < 2:
        return tau
    d = floor_mod(torch.diff(tau, dim=-1) + period / 2, period) - period / 2
    return torch.cat([tau[..., :1], tau[..., :1] + blocked_cumsum(d)],
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
    cs, sn = cos_sin(ang[:m])
    Xr = tree_sum((er * cs).reshape(c, nw, -1))
    Xi = tree_sum((er * sn).reshape(c, nw, -1))
    tau = floor_mod(-atan2(Xi, Xr) * (sps / (2 * math.pi)), sps)
    tau = _unwrap_mod(tau, sps)
    centers = (torch.arange(nw, dtype=torch.float32, device=dev) + 0.5) * L
    K = max_symbols if max_symbols is not None else int((n - 2 * sps) // sps)
    base = torch.arange(K, dtype=torch.float32, device=dev) * sps
    return torch.clamp(base[None, :] + interp(base, centers, tau),
                       0.0, n - 2.0)


def recover_symbols(d: torch.Tensor, sps: float, win_symbols: int = 256,
                    max_symbols: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symbol-rate samples of ``[C, N]`` float32 discriminator samples:
    the mean removed, the squared signal's symbol-rate line timed per
    window (:func:`decision_positions`), and each symbol read by linear
    interpolation at its instant.  Returns (symbols ``[C, K]``,
    positions ``[C, K]``), ``K`` = ``max_symbols`` or what fills the
    input."""
    n = d.shape[1]
    dc = tree_sum(d)[:, None] * float(np.float32(1.0 / n))
    pos = decision_positions((d - dc) ** 2, sps, win_symbols, max_symbols)
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0.to(torch.float32)
    g0 = torch.gather(d, 1, i0)
    g1 = torch.gather(d, 1, i0 + 1)
    # XLA contracts g0·(1 − frac) + g1·frac into fma(g0, 1 − frac, g1·frac)
    return fma_f32(g0, 1.0 - frac, g1 * frac), pos


def recover_symbols_fixed(d: torch.Tensor, sps: float,
                          win_symbols: int = 256,
                          max_symbols: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single global timing phase variant (no drift tracking) — the
    ``DSD_NEO_WINDOW_FREEZE`` branch of the serial front end.  The tone's
    sum runs over the whole row in XLA's order (``tree_sum``); on the
    card, cos and sin of the phase (up to ~3.6e6 rad on a 60 s row)
    reduce their arguments otherwise than the C library, so the card is
    held to the CPU path on dibits off the slicer's thresholds."""
    c, n = d.shape
    dev = d.device
    dc = tree_sum(d)[:, None] * float(np.float32(1.0 / n))
    e = (d - dc) ** 2
    idx = torch.arange(n, dtype=torch.float32, device=dev)
    cs, sn = cos_sin(idx * float(np.float32(-2.0 * math.pi / sps)))
    tau = floor_mod(-atan2(tree_sum(e * sn), tree_sum(e * cs))
                    * (sps / (2 * math.pi)), sps)
    K = max_symbols if max_symbols is not None else int((n - 2 * sps) // sps)
    k = torch.arange(K, dtype=torch.float32, device=dev)
    pos = torch.clamp(k[None, :] * sps + tau[:, None], 0.0, n - 2.0)
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0.to(torch.float32)
    g0 = torch.gather(d, 1, i0)
    g1 = torch.gather(d, 1, i0 + 1)
    return fma_f32(g0, 1.0 - frac, g1 * frac), pos
