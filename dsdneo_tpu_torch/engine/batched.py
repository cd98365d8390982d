"""The many-channel front-end step: I/Q → dibits, soft symbols, power.

Counterpart of ``dsdneo_tpu/engine/batched.py`` (``frontend_step``,
``symbolize_step``).  On a CUDA tensor the FIR + discriminator runs
through kernel K1 (``ops.fir_discriminate``), the counterpart of the
JAX package's ``use_pallas``; on a CPU tensor through its plain version.
Timing recovery, level tracking and slicing are plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from dsdneo_tpu_torch.dsp.frontend import floor_mod
from dsdneo_tpu_torch.ops.fir_discriminate import fir_discriminate


def frontend_step(iq: torch.Tensor, taps: torch.Tensor, sps: float,
                  n_sym: int, four_level: bool = True):
    """``[C, B, 2]`` float32 I/Q planes → (dibits ``[C, n_sym]`` uint8,
    soft symbols ``[C, n_sym]`` float32, power ``[C]``)."""
    xr = iq[..., 0].contiguous()
    xi = iq[..., 1].contiguous()
    d = fir_discriminate(xr, xi, taps)
    dibits, norm = symbolize_step(d, sps, n_sym, four_level)
    power = torch.mean(xr * xr + xi * xi, dim=-1)
    return dibits, norm, power


def symbolize_step(d: torch.Tensor, sps: float, n_sym: int,
                   four_level: bool = True):
    """Timing recovery + level tracking + slicing of ``[C, B]``
    discriminator samples → (dibits, soft symbols)."""
    c, n = d.shape
    dev = d.device
    # -- timing: windowed, energy-normalized Oerder & Meyr estimate ------
    dc = torch.mean(d, dim=-1, keepdim=True)
    e = (d - dc) ** 2
    idx = torch.arange(n, dtype=torch.float32, device=dev)
    ang = (2.0 * math.pi / sps) * idx
    wlen = min(2048, n)
    nww = n // wlen
    ec = e[:, :nww * wlen].reshape(c, nww, wlen)
    cr = torch.cos(ang[:nww * wlen]).reshape(nww, wlen)
    ci = torch.sin(ang[:nww * wlen]).reshape(nww, wlen)
    Xr = torch.sum(ec * cr[None], dim=-1)                   # [C, nw]
    Xi = -torch.sum(ec * ci[None], dim=-1)
    w = 1.0 / (torch.sum(ec, dim=-1) + 1e-9)
    Xre = torch.sum(Xr * w, dim=-1)
    Xim = torch.sum(Xi * w, dim=-1)
    tau = floor_mod(-torch.atan2(Xim, Xre) * (sps / (2 * math.pi)), sps)

    isps = int(round(sps))
    if abs(sps - isps) < 1e-9 and n_sym * isps + isps <= n:
        # integer samples/symbol: reshape + one-hot weights over the phase
        o = torch.floor(tau).to(torch.int32)                  # [C]
        frac = (tau - o.to(torch.float32))[:, None]           # [C, 1]
        dr = d[:, :n_sym * isps].reshape(c, n_sym, isps)
        nxt = d[:, isps:n_sym * isps + isps:isps]             # [C, K]
        dr = torch.cat([dr, nxt[:, :, None]], dim=2)          # [C, K, sps+1]
        j = torch.arange(isps + 1, dtype=torch.int32, device=dev)[None, :]
        oc = o[:, None]
        wts = (torch.where(j == oc, 1.0 - frac, 0.0)
               + torch.where(j == oc + 1, frac, 0.0))         # [C, sps+1]
        sym = torch.einsum("ckj,cj->ck", dr, wts)
    else:
        k = torch.arange(n_sym, dtype=torch.float32, device=dev)
        pos = k[None, :] * sps + tau[:, None]
        pos = torch.clamp(pos, 0.0, n - 2.0)
        i0 = torch.floor(pos).to(torch.int64)
        frac = pos - i0.to(torch.float32)
        g0 = torch.gather(d, 1, i0)
        g1 = torch.gather(d, 1, i0 + 1)
        sym = g0 * (1.0 - frac) + g1 * frac

    # -- levels: windowed min/max ----------------------------------------
    win = min(256, n_sym)
    nw = max(n_sym // win, 1)
    body = sym[:, :nw * win].reshape(c, nw, win)
    hi = torch.amax(body, dim=-1)
    lo = torch.amin(body, dim=-1)
    center = torch.repeat_interleave((hi + lo) * 0.5, win, dim=-1)
    # a window with no real discriminator swing slices to silence
    # (scale inf → norm 0), not to amplified numerical dust
    swing = torch.clamp((hi - lo) * 0.5, min=1e-6)
    scale = torch.repeat_interleave(
        torch.where(swing < 1e-5, torch.full_like(swing, math.inf), swing),
        win, dim=-1)
    pad = n_sym - nw * win
    if pad > 0:
        center = torch.cat([center, center[:, -1:].expand(c, pad)], dim=-1)
        scale = torch.cat([scale, scale[:, -1:].expand(c, pad)], dim=-1)
    norm = (sym - center) / scale * 3.0

    if four_level:
        neg = norm < 0.0
        outer = norm.abs() > 2.0
        dibits = torch.where(neg, torch.where(outer, 3, 2),
                             torch.where(outer, 1, 0))
    else:
        dibits = torch.where(norm < 0.0, 3, 1)
    return dibits.to(torch.uint8), norm
