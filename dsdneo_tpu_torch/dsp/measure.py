"""Signal-quality estimators: per-modulation SNR, squelch, spectrum.

The port's counterpart of ``dsdneo_tpu/dsp/measure.py`` (reference
src/dsp/snr_estimator.cpp C4FM eye / QPSK constellation SNR with the
snr_bias.cpp corrections, the power squelch of demod_pipeline.cpp, the
spectrum snapshot of rtl_metrics.cpp).  The estimators are batched
``[C, ...]`` functions in plain PyTorch that run where their tensor
lies; ``snr_bias_db`` is host arithmetic, which
``engine.stream.StreamDecoder`` applies to its eye SNR.
"""

from __future__ import annotations

import numpy as np
import torch


def _db(ratio: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(ratio, min=1e-9))


def snr_c4fm_eye(norm_symbols: torch.Tensor) -> torch.Tensor:
    """Eye-based SNR (dB) for 4-level symbols normalized to ±1/±3:
    signal power of the ideal levels vs residual around nearest level."""
    lv = torch.tensor([1.0, 3.0, -1.0, -3.0], dtype=norm_symbols.dtype,
                      device=norm_symbols.device)
    d = torch.min(torch.abs(norm_symbols[..., None] - lv), dim=-1).values
    noise = torch.mean(d ** 2, dim=-1)
    sig = torch.mean(norm_symbols ** 2, dim=-1)
    return _db(sig / torch.clamp(noise, min=1e-9))


def snr_qpsk_constellation(symbols: torch.Tensor) -> torch.Tensor:
    """SNR (dB) from unit-circle spread of differential QPSK phasors."""
    mag = torch.abs(symbols)
    mean_mag = torch.mean(mag, dim=-1, keepdim=True)
    err = torch.mean((mag - mean_mag) ** 2, dim=-1)
    sig = torch.mean(mag ** 2, dim=-1)
    return _db(sig / torch.clamp(err, min=1e-9))


# -- SNR bias correction (reference src/dsp/snr_bias.cpp) ------------------
#
# The variance-ratio estimators above are biased by (a) the statistics of
# the clustering method and (b) the ratio of channel-filter noise
# bandwidth to symbol rate.  bias_total = bias_est + 10 log10(Bn / Rs).

_ESTIMATOR_BIAS_DB = {"c4fm": 5.73, "evm": 1.92}

# Noise-equivalent bandwidth (Hz) per channel-LPF profile, computed as
# Bn = (Fs/2)·Σh²/(Σh)² for the reference 24 kHz designs
# (snr_bias.cpp kNoiseBw*).
NOISE_BW_HZ = {"wide": 8415.0, "6k25": 3540.0, "12k5": 6665.0,
               "provoice": 6665.0, "p25_c4fm": 6665.0, "p25_cqpsk": 7065.0}


def snr_bias_db(kind: str, symbol_rate: float,
                lpf_profile: str = "wide") -> float:
    """Total bias (dB) to subtract from a raw eye/EVM SNR estimate.

    kind: 'c4fm' (4-level eye) or 'evm' (QPSK/GFSK constellation).
    Fallbacks match the reference's original empirical calibrations
    (7.95 dB / 2.43 dB) when the symbol rate is unknown."""
    est = _ESTIMATOR_BIAS_DB.get(kind, _ESTIMATOR_BIAS_DB["evm"])
    if symbol_rate <= 0:
        return est + (2.2 if kind == "c4fm" else 0.5)
    bn = NOISE_BW_HZ.get(lpf_profile, NOISE_BW_HZ["wide"])
    return est + 10.0 * float(np.log10(bn / symbol_rate))


def snr_corrected_db(raw_db, kind: str, symbol_rate: float,
                     lpf_profile: str = "wide"):
    """Apply the bias correction to a raw SNR estimate."""
    return raw_db - snr_bias_db(kind, symbol_rate, lpf_profile)


def power_squelch(iq: torch.Tensor, threshold_db: float = -110.0
                  ) -> torch.Tensor:
    """Per-channel open/closed gate from mean input power (dBFS)."""
    p = torch.mean(torch.abs(iq) ** 2, dim=-1)
    db = 10.0 * torch.log10(torch.clamp(p, min=1e-20))
    return db > threshold_db


def spectrum_snapshot(iq: torch.Tensor, nfft: int = 1024) -> torch.Tensor:
    """Averaged power spectrum ``[C, nfft]`` in dB (UI + auto-PPM food)."""
    c, n = iq.shape
    m = n // nfft
    x = iq[:, : m * nfft].reshape(c, m, nfft)
    # numpy's (and jnp's) symmetric Hann window
    w = torch.from_numpy(np.hanning(nfft).astype(np.float32)).to(iq.device)
    spec = torch.fft.fftshift(torch.abs(torch.fft.fft(x * w, dim=-1)) ** 2,
                              dim=-1)
    avg = torch.mean(spec, dim=1)
    return 10.0 * torch.log10(torch.clamp(avg, min=1e-20))


def estimate_cfo_fm(disc: torch.Tensor, fs: float) -> torch.Tensor:
    """Carrier-offset estimate (Hz) from discriminator DC — the auto-PPM
    observable (reference src/io/radio/rtl_auto_ppm.cpp)."""
    return torch.mean(disc, dim=-1) * (fs / 2.0)
