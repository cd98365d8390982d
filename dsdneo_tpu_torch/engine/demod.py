"""The serial front end and the power-gated front end: I/Q → dibits.

Counterpart of ``dsdneo_tpu/engine/demod.py``: ``demod_fm`` (its
``_demod_fm_jit``), ``demod_disc``, ``demod_cqpsk_path`` and
``gated_frontend_step``, the front end of D-STAR and M17 (and of YSF,
dPMR and the EDACS monitor).  The FM chain: the channel FIR
(``dsp.frontend.fir_complex``, full float32 on the card too), the FM
discriminator, a power gate that zeroes
the discriminator where ``|y|²`` of the filtered signal is under 2% of
the block's peak (dead air gives full-scale random angles that would
poison the timing and level estimates), the windowed O&M timing
(``symbols.timing.recover_symbols``) and the windowed-quantile slicer
(``symbols.slicer.slice_dibits``, ``win=512``).  The serial entry
``demod_fm`` runs the same chain with its two environment branches:
``DSD_NEO_CHANNEL_LPF=0`` skips the FIR and ``DSD_NEO_WINDOW_FREEZE``
takes one global timing phase (``recover_symbols_fixed``).  Complex
input becomes complex64 at the boundary; the results come back to the
host as numpy arrays, as the JAX functions return them.

Kernel K1 does not serve here: the gate needs ``|y|²`` of the filtered
signal, which K1 does not output, and the JAX function does not call
its Pallas kernel either.  This stage is plain PyTorch on either device.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from dsdneo_tpu_torch.device import require_cuda
from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.dsp.frontend import (fir_complex, fm_discriminate,
                                           iq_power)
from dsdneo_tpu_torch.engine.batched import slice_four_level, symbolize_step
from dsdneo_tpu_torch.engine.modes import MODES, ModeConfig
from dsdneo_tpu_torch.runtime import config as rtcfg
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
                        n_sym: int, four_level: bool = True,
                        freeze: bool = False, use_lpf: bool = True):
    """``[C, B, 2]`` float32 I/Q planes → (dibits ``[C, n_sym]`` uint8,
    soft symbols ``[C, n_sym]`` float32, normalized to ±3): the channel
    FIR (skipped when ``use_lpf`` is false), the discriminator, the
    power gate, the windowed timing (one global phase when ``freeze``)
    and the windowed slicer."""
    x = torch.complex(iq[..., 0], iq[..., 1])
    y = fir_complex(x, taps) if use_lpf else x
    d = torch.where(gate_mask(y), fm_discriminate(y), 0.0)
    if freeze:
        sym, _pos = timing.recover_symbols_fixed(d, sps, max_symbols=n_sym)
    else:
        sym, _pos = timing.recover_symbols(d, sps, win_symbols=256,
                                           max_symbols=n_sym)
    return slicer.slice_dibits(sym, win=512, four_level=four_level)


def demod_fm_step(iq: torch.Tensor, taps: torch.Tensor, sps: float,
                  four_level: bool, n_sym: int, freeze: bool = False,
                  use_lpf: bool = True):
    """The ``_demod_fm_jit`` step: (dibits, soft, mean I/Q power ``[C]``)."""
    dibits, norm = gated_frontend_step(iq, taps, sps, n_sym, four_level,
                                       freeze, use_lpf)
    return dibits, norm, iq_power(torch.complex(iq[..., 0], iq[..., 1]))


@functools.lru_cache(maxsize=32)
def _taps_for(profile: str, fs: float) -> np.ndarray:
    return firdes.channel_lpf(fs, profile)


def _mode(mode: ModeConfig | str) -> ModeConfig:
    return MODES[mode] if isinstance(mode, str) else mode


def _device(device) -> torch.device:
    """The caller's device, or the card (raises when there is none)."""
    return require_cuda() if device is None else torch.device(device)


def _planes(samples, dev: torch.device) -> torch.Tensor:
    """``[C, N]`` complex samples → ``[C, N, 2]`` float32 planes on
    ``dev`` (complex64 first, as the JAX package converts them)."""
    x = np.asarray(samples).astype(np.complex64)
    return torch.view_as_real(torch.from_numpy(x)).to(dev)


def _host(dibits: torch.Tensor, soft: torch.Tensor, squeeze: bool):
    dibits, soft = dibits.cpu().numpy(), soft.cpu().numpy()
    if squeeze:
        return dibits[0], soft[0]
    return dibits, soft


def demod_fm(samples: np.ndarray, mode: ModeConfig | str,
             fs: float = 48000.0, device=None
             ) -> tuple[np.ndarray, np.ndarray]:
    """Demodulate ``[N]`` or ``[C, N]`` complex baseband → (dibits, soft)
    as numpy arrays.  FM/FSK/C4FM path (CQPSK uses
    :func:`demod_cqpsk_path`).  Runs on ``device``: the card when none
    is given (raises when there is none)."""
    mode = _mode(mode)
    dev = _device(device)
    x = np.asarray(samples)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    sps = fs / mode.symbol_rate
    n_sym = int((x.shape[1] - 2 * sps) // sps)
    taps = torch.as_tensor(_taps_for(mode.lpf_profile, fs), device=dev)
    cfg = rtcfg.get()
    dibits, norm, _power = demod_fm_step(
        _planes(x, dev), taps, sps, mode.four_level, n_sym,
        freeze=cfg.window_freeze, use_lpf=cfg.channel_lpf)
    return _host(dibits, norm, squeeze)


def demod_disc(samples: np.ndarray, mode: ModeConfig | str,
               fs: float = 48000.0, device=None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Demodulated-PCM (discriminator-tap) input → (dibits, soft):
    timing + slicing only, no I/Q front end (the reference's UDP/TCP
    PCM16LE sources, src/io/audio_backends/udp_input.c:1)."""
    mode = _mode(mode)
    dev = _device(device)
    x = np.asarray(samples, dtype=np.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    sps = fs / mode.symbol_rate
    n_sym = int((x.shape[1] - 2 * sps) // sps)
    dibits, norm = symbolize_step(torch.from_numpy(x).to(dev), sps, n_sym,
                                  mode.four_level)
    return _host(dibits, norm, squeeze)


def demod_cqpsk_path(samples: np.ndarray, mode: ModeConfig | str,
                     fs: float = 48000.0, device=None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """CQPSK/LSM demod → (dibits, soft) in the shared ±1/±3 alphabet."""
    from dsdneo_tpu_torch.dsp.cqpsk import demod_cqpsk
    mode = _mode(mode)
    dev = _device(device)
    x = np.asarray(samples)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    # CQPSK tuning knobs (docs/cli.md:310-314, 569-576): loop-dynamics
    # equivalents for the feed-forward chain + polarity tweaks
    cfg = rtcfg.get()
    xt = torch.view_as_complex(_planes(x, dev))
    if cfg.cqpsk_sync_neg:
        # DSD_NEO_CQPSK_SYNC_NEG: spectral inversion of the capture
        xt = xt.conj().resolve_conj()
    pull_in = cfg.costas_bw * float(mode.symbol_rate) \
        if cfg.costas_bw > 0 else 0.0
    prior, alpha = None, 1.0
    if cfg.costas_damping > 0:
        prior = getattr(demod_cqpsk_path, "_cfo_ema", None)
        alpha = 1.0 / (1.0 + cfg.costas_damping)
    # DSD_NEO_CFO_WINDOWS: carrier-drift tracking granularity.  0 (the
    # default) picks one ~0.25 s estimation window per block — the
    # feed-forward stand-in for the reference FLL's continuous tracking
    # (src/dsp/costas.cpp:1176); 1 forces the legacy whole-block
    # estimate; N>1 forces N windows.
    windows = cfg.cfo_windows
    if windows <= 0:
        windows = max(1, int(x.shape[-1] / (fs * 0.25)))
    soft, cfo = demod_cqpsk(xt, fs, float(mode.symbol_rate),
                            ted_gain=cfg.ted_gain, pull_in_hz=pull_in,
                            cfo_prior=prior, cfo_alpha=alpha,
                            cfo_windows=windows)
    cfo = cfo.cpu().numpy()
    if cfg.costas_damping > 0:
        demod_cqpsk_path._cfo_ema = float(cfo.mean())
    if cfg.debug_cqpsk:
        logging.getLogger(__name__).debug(
            "CQPSK: cfo=%.1f Hz win_gain=%.2f pull_in=%.0f Hz",
            float(cfo.mean()), cfg.ted_gain, pull_in)
    if cfg.cqpsk_sync_inv:
        # DSD_NEO_CQPSK_SYNC_INV: symbol polarity inversion
        soft = -soft
    return _host(slice_four_level(soft), soft, squeeze)
