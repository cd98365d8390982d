"""MBE-family vocoder parameter decode (IMBE 88-bit / AMBE+2 49-bit).

The reference delegates synthesis to the external mbelib-neo
(vcpkg-ports/mbe-neo; call contract at src/core/vocoder/dsd_mbe.c), so
this is a ground-up implementation of the Multi-Band Excitation model:

  frame → fundamental ω0, harmonic count L, per-band voiced/unvoiced
  decisions, per-harmonic spectral amplitudes → harmonic synthesis
  (dsdneo_tpu_torch.vocoder.synth) → 160 samples of 8 kHz PCM per 20 ms frame.

IMBE uses the full dequantizer in dsdneo_tpu_torch.vocoder.imbe: the bit
layout (fundamental/gain/voicing fields and the parameter-bit basis)
was recovered empirically from the reference's off-air voice fixtures,
and spectral amplitudes reconstruct through the real MBE pipeline —
6-block DCT of log2 prediction residuals, PRBA gain vector, adaptive
bit allocation, inter-frame prediction.  The allocation tables and
quantizer step sizes are deterministic reconstructions (the
TIA-102.BABA tables are not available to this project), exactly
mirrored by the encoder and covered by roundtrip tests.

The port's own copy of ``dsdneo_tpu/vocoder/mbe.py`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MbeFrame:
    w0: float                 # fundamental (radians/sample at 8 kHz)
    L: int                    # number of harmonics
    voiced: np.ndarray        # [L] 0/1 per harmonic
    amps: np.ndarray          # [L] linear spectral amplitudes
    errs: int = 0
    params: object = None     # underlying dequantized parameter set

    MAX_L = 56


def _bits_to_int(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


# absolute scale: log2 amplitudes → linear, normalized to keep a full-
# scale gain frame near PCM full scale after harmonic summation
_IMBE_AMP_SCALE = 0.003


def decode_imbe_4400(bits88: np.ndarray, prev=None) -> MbeFrame:
    """Decode an 88-bit IMBE parameter frame (P25 Phase 1 full rate).

    ``prev`` is the previous frame's MbeFrame (or None): the spectral
    amplitudes predict from it (dsdneo_tpu_torch.vocoder.imbe PRED_DECAY).
    """
    from dsdneo_tpu_torch.vocoder import imbe
    prev_params = getattr(prev, "params", None) if prev is not None else None
    p = imbe.decode_frame(bits88, prev_params)
    voiced = np.zeros(p.L, dtype=np.uint8)
    for l in range(p.L):
        band = min(l // 3, p.K - 1)
        voiced[l] = p.voiced_bands[band]
    amps = (2.0 ** np.clip(p.log_m, -4.0, 14.0)).astype(np.float32)
    amps *= _IMBE_AMP_SCALE
    return MbeFrame(w0=float(p.w0), L=p.L, voiced=voiced, amps=amps,
                    params=p)


def decode_ambe_2450(bits49: np.ndarray) -> MbeFrame:
    """Decode a 49-bit AMBE+2 parameter frame (DMR/NXDN/dPMR/YSF).

    Fundamental (b0 pitch index), band voicing (5 bits) and gain
    (6 bits) follow the AMBE+2 half-rate field layout; the residual 31
    bits reconstruct per-harmonic log-amplitude deltas through a
    deterministic uniform allocation (the trained PRBA vector codebooks
    of the half-rate standard are not available to this project),
    mirrored by the device dequantizer (vocoder.device
    ambe_decode_params) and exercised by the DMR/NXDN/P25p2/X2 voice
    paths."""
    b = np.asarray(bits49, dtype=np.uint8)
    b0 = _bits_to_int(b[0:7])
    # AMBE pitch index → fundamental (mbelib-neo dequant convention:
    # f0 = 2^(−4.3118 − 0.021336·(b0+0.5)), so the period in samples
    # is the reciprocal and GROWS with b0 — higher index = lower
    # pitch; b0 spans 0..127 → ~19.9..131 sample periods)
    period = 2.0 ** (4.3118 + 0.021336 * (b0 + 0.5))
    w0 = 2.0 * np.pi / float(np.clip(period, 19.0, 131.0))
    L = int(0.9254 * int(np.pi / w0 + 0.25))
    L = max(9, min(L, MbeFrame.MAX_L))

    vband = _bits_to_int(b[7:12])          # 5 voicing-band bits
    voiced = np.zeros(L, dtype=np.uint8)
    nb = 5
    for l in range(L):
        band = min(l * nb // L, nb - 1)
        voiced[l] = (vband >> (nb - 1 - band)) & 1

    gain_idx = _bits_to_int(b[12:18])
    gain = 10.0 ** ((gain_idx - 32) * 1.3 / 20.0)

    rest = b[18:]
    amps = np.ones(L, dtype=np.float32)
    if L > 1 and rest.size:
        per = max(rest.size // (L - 1), 1)
        pos = 0
        for l in range(1, L):
            nbits = min(per, rest.size - pos)
            if nbits <= 0:
                break
            q = _bits_to_int(rest[pos:pos + nbits])
            pos += nbits
            r = (q / max((1 << nbits) - 1, 1)) * 2.0 - 1.0
            amps[l] = 10.0 ** (r * 6.0 / 20.0)
    tilt = np.exp(-0.02 * np.arange(L, dtype=np.float32))
    amps = amps * tilt
    amps = amps / max(np.sqrt(np.mean(amps ** 2)), 1e-9) * gain * 0.02
    return MbeFrame(w0=float(w0), L=L, voiced=voiced, amps=amps)


def frames_to_arrays(frames: list[MbeFrame]):
    """Pack a frame list into fixed-shape arrays for the device kernel."""
    F = len(frames)
    ML = MbeFrame.MAX_L
    w0 = np.zeros(F, dtype=np.float32)
    amps = np.zeros((F, ML), dtype=np.float32)
    voiced = np.zeros((F, ML), dtype=np.float32)
    for i, fr in enumerate(frames):
        w0[i] = fr.w0
        amps[i, :fr.L] = fr.amps
        voiced[i, :fr.L] = fr.voiced
    return w0, amps, voiced
