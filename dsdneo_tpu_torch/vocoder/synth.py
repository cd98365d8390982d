"""Batched MBE harmonic synthesis over many channels.

Counterpart of ``dsdneo_tpu/vocoder/synth.py`` (``synthesize_stream``,
``synthesize``), with the JAX package's ``vmap`` over channels written
out as a leading channel axis.  Per channel and 160-sample frame:

  - voiced bands: Σ_l 2·A_l·cos(l·θ(n)), the fundamental phase θ carried
    across frames and blocks, ω0 and A interpolated across each frame;
    the harmonic phasors e^{ilθ} come from (cos θ, sin θ) by log-doubling
    and the amplitude interpolation is separable in n, so the sum is one
    batched ``[160, 56] × [56, 2]`` product per frame;
  - unvoiced bands: banded noise on the fixed 50 Hz grid, a
    ``[79] × [79, 160]`` product per frame against constant bin bases.

The phasor bank is ``[C, F, 160, 56]`` per plane (~1.9 GB at C=320,
F=162), so channels go through in chunks that keep one plane of the
bank under ``params.TILE_BYTES``; the phase θ and its carry, a few
hundred small sequential adds, are taken once for all channels before
the chunks.  Plain PyTorch: the JAX package
computes this outside any Pallas kernel.

``synthesize_frames`` is the host vocoder's entry (the serial decode
path's): a list of decoded frames synthesized as one stream on the
decode's device, with the JAX package's noise phases
(``default_rng(1234)``) and its peak normalisation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.device import f32_scalar, require_cuda
from dsdneo_tpu_torch.dsp.frontend import floor_mod
from dsdneo_tpu_torch.params import MAX_L, TILE_BYTES

N = 160                          # samples per 20 ms frame at 8 kHz
SCAN_BLOCK = 16
TREE_WINDOW = 32


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in the order XLA's CPU backend
    takes ``jnp.cumsum``: sequential within blocks of 16, the block
    totals summed the same way recursively, each block offset by the
    running total before it.  The fundamental phase is a sum of
    thousands of f32 increments, and its harmonics multiply the rounding
    up to 56 times, so the port takes the sum in the JAX package's
    order; the adds are elementwise, so the card gives the same bits."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, dim=-1)
    nb = -(-n // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n))
    inner = blocked_cumsum(xp.reshape(*x.shape[:-1], nb, SCAN_BLOCK))
    outer = blocked_cumsum(inner[..., -1])
    excl = torch.cat([torch.zeros_like(outer[..., :1]), outer[..., :-1]],
                     dim=-1)
    return (inner + excl[..., None]).reshape(*x.shape[:-1], -1)[..., :n]


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order XLA's CPU backend takes
    ``jnp.sum``: up to 32 terms sequentially; a longer axis is
    zero-padded to a multiple of 32 (half the padding in front, the odd
    one behind), each window of 32 summed sequentially, and the window
    sums summed the same way recursively.  The theta carry between
    blocks is such a sum of up to hundreds of frame advances of ~10
    radians, so the port takes it in the JAX package's order."""
    n = x.shape[-1]
    if n <= TREE_WINDOW:
        return _sequential_sum(x)
    p = -(-n // TREE_WINDOW) * TREE_WINDOW
    lo = (p - n) // 2
    xp = torch.nn.functional.pad(x, (lo, p - n - lo))
    return tree_sum(_sequential_sum(
        xp.reshape(*x.shape[:-1], p // TREE_WINDOW, TREE_WINDOW)))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a · b + c`` rounded once to float32, as XLA's CPU backend
    contracts the multiply-add of the ω interpolation into an FMA.  The
    product of two float32 values is exact in float64, so the float64
    sum rounds to the fused result (a double rounding can differ from it
    only on an exact float32 tie, a 2^-29 event)."""
    return (a.double() * b.double() + c.double()).float()


def _phase(w0, theta_in, w_in):
    """The fundamental phase θ ``[C, F, N]`` of every channel at once,
    the carry θ_out ``[C]``, and the amplitude interpolation weight
    ``alpha`` ``[N]``.  Each add is elementwise across channels, so the
    sums keep the JAX package's order whatever the channel chunking."""
    dev = w0.device
    n_idx = torch.arange(N, dtype=torch.float32, device=dev)
    w_prev0 = torch.where(w_in <= 0.0, w0[:, 0], w_in)
    w_prev = torch.cat([w_prev0[:, None], w0[:, :-1]], dim=1)      # [C,F]

    # θ(n) = θ0 + Σ_{m<=n} ω(m), ω(m) = ω_prev + (ω - ω_prev)(m+1)/N
    # XLA compiles a division by a constant as a product with its
    # reciprocal; the port takes the same product
    alpha = (n_idx + 1.0) * f32_scalar(1.0 / N, dev)          # [N]
    w_t = fma_f32((w0 - w_prev)[..., None], alpha,
                  w_prev[..., None])                           # [C,F,N]
    cum = blocked_cumsum(w_t)
    frame_adv = cum[..., -1]                                  # [C,F]
    if w0.shape[1] > 1:
        theta0 = torch.cat([torch.zeros_like(frame_adv[:, :1]),
                            blocked_cumsum(frame_adv[:, :-1])], dim=1)
    else:
        theta0 = torch.zeros_like(frame_adv)
    theta0 = floor_mod(theta_in[:, None] + theta0, 2 * math.pi)
    theta = theta0[..., None] + cum                           # [C,F,N]
    theta_out = floor_mod(theta_in + tree_sum(frame_adv), 2 * math.pi)
    return theta, theta_out, alpha


def _synth_chunk(theta, alpha, w0, amps, voiced, noise_phase, w_in, a_in,
                 tables):
    dev = w0.device
    a_prev0 = torch.where((w_in <= 0.0)[:, None], amps[:, 0], a_in)
    a_prev = torch.cat([a_prev0[:, None], amps[:, :-1]], dim=1)  # [c,F,L]

    v = voiced > 0.5
    P = v.to(torch.float32)

    # phasors z^l = e^{ilθ} by log-doubling from (cos θ, sin θ)
    pr = torch.cos(theta)[..., None]                          # [c,F,N,1]
    pi = torch.sin(theta)[..., None]
    while pr.shape[-1] < MAX_L:
        zkr = pr[..., -1:]
        zki = pi[..., -1:]
        pr, pi = (torch.cat([pr, pr * zkr - pi * zki], dim=-1),
                  torch.cat([pi, pr * zki + pi * zkr], dim=-1))
    pr = pr[..., :MAX_L]                                      # cos(lθ)
    del pi

    cc = torch.stack([amps * P, a_prev * P], dim=-1)          # [c,F,L,2]
    S = torch.matmul(pr, cc)                                  # [c,F,N,2]
    del pr
    pcm = 2.0 * (alpha * S[..., 0] + (1.0 - alpha) * S[..., 1])

    # unvoiced bands: banded noise on the fixed 50 Hz grid
    L = amps.shape[-1]
    w0_safe = torch.clamp(w0, min=1e-3)[..., None]            # [c,F,1]
    wbin = f32_scalar(2.0 * math.pi / N, dev)
    l_raw = torch.floor(tables.synth_bin_w / w0_safe + 0.5).to(torch.int64)
    in_band = (l_raw >= 1) & (l_raw <= L)
    li = torch.clamp(l_raw, 1, L) - 1                         # [c,F,K]
    a_k = torch.gather(amps, 2, li)
    uv_k = 1.0 - torch.gather(P, 2, li)
    c_k = (2.0 * a_k * torch.sqrt(wbin / w0_safe) * uv_k
           * in_band.to(torch.float32))
    phi = noise_phase[..., tables.synth_bin_l] + tables.synth_phi_off
    pcm = pcm + (torch.matmul(c_k * torch.cos(phi), tables.synth_bin_cos)
                 + torch.matmul(c_k * torch.sin(phi), tables.synth_bin_sin))
    return pcm


def synthesize_stream(w0, amps, voiced, noise_phase, theta_in, w_in, a_in,
                      *, tables):
    """Streaming synthesis of C channels: ω0 ``[C, F]``, amps / voiced /
    noise phases ``[C, F, 56]``, and the carry from the previous block
    (θ ``[C]``, last ω0 ``[C]``, last amps ``[C, 56]``; ``w_in <= 0``
    means no previous frame) → (pcm ``[C, F, 160]``, θ_out, w_out,
    a_out)."""
    C, F = w0.shape
    theta, theta_out, alpha = _phase(w0, theta_in, w_in)
    per_channel = max(1, F * N * MAX_L * 4)
    step = max(1, TILE_BYTES // per_channel)
    pcm = torch.cat([_synth_chunk(theta[s:s + step], alpha, w0[s:s + step],
                                  amps[s:s + step], voiced[s:s + step],
                                  noise_phase[s:s + step], w_in[s:s + step],
                                  a_in[s:s + step], tables)
                     for s in range(0, C, step)])
    return pcm, theta_out, w0[:, -1], amps[:, -1]


def synthesize(w0, amps, voiced, noise_phase, *, tables):
    """One-shot synthesis of one stream: ω0 ``[F]``, amps / voiced /
    noise phases ``[F, 56]`` → pcm ``[F, 160]``."""
    z = torch.zeros(1, dtype=torch.float32, device=w0.device)
    pcm, _t, _w, _a = synthesize_stream(
        w0[None], amps[None], voiced[None], noise_phase[None], z, z,
        torch.zeros_like(amps[:1]), tables=tables)
    return pcm[0]


def synthesize_frames(frames, device=None) -> np.ndarray:
    """list[MbeFrame] → concatenated float PCM ``[F·160]`` (numpy),
    synthesized on ``device``: the card when none is given (raises when
    there is none)."""
    from dsdneo_tpu_torch.vocoder.mbe import frames_to_arrays
    if not frames:
        return np.zeros(0, dtype=np.float32)
    dev = require_cuda() if device is None else torch.device(device)
    w0, amps, voiced = frames_to_arrays(frames)
    rng = np.random.default_rng(1234)
    noise = rng.uniform(0, 2 * np.pi,
                        size=voiced.shape).astype(np.float32)
    pcm = synthesize(*(torch.from_numpy(a).to(dev)
                       for a in (w0, amps, voiced, noise)),
                     tables=params.load_synth(dev))
    out = pcm.cpu().numpy().reshape(-1)
    peak = np.abs(out).max()
    if peak > 0.5:
        out = out * (0.5 / peak)
    return out
