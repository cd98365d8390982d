"""Batched analog NBFM voice channels: EDACS working channels and analog
monitoring at fleet scale.

Counterpart of ``dsdneo_tpu/engine/analogbatch.py``.  Every channel is a
row of one device program: the wide channel low-pass, the FM
discriminator, an RMS squelch (rows without a carrier stay silent), a
64-tap voice-band low-pass and the polyphase resampler down to 8 kHz.
Plain PyTorch on the block's device: no recurrence runs here, so no
kernel of the table is on this path.
"""

from __future__ import annotations

import numpy as np
import torch

from dsdneo_tpu_torch.device import require_cuda
from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.dsp.frontend import (fir_complex, fir_real,
                                           fm_discriminate)
from dsdneo_tpu_torch.dsp.resampler import resample
from dsdneo_tpu_torch.vocoder.synth import tree_sum

SQUELCH_RMS = 0.2     # no-carrier rows discriminate to ~0.29 rms noise


def analog_voice_decode(x: torch.Tensor, fs: float = 48000.0
                        ) -> torch.Tensor:
    """``[C, N]`` complex baseband (or ``[C, N, 2]`` float32 planes) →
    ``[C, K]`` float32 voice PCM at 8 kHz.  Rows whose discriminator RMS
    reaches the no-carrier noise floor squelch to silence."""
    if not x.is_complex():
        x = torch.complex(x[..., 0].contiguous(), x[..., 1].contiguous())
    dev = x.device
    taps = torch.as_tensor(firdes.channel_lpf(fs, "wide"), device=dev)
    y = fir_complex(x, taps)
    d = fm_discriminate(y)
    # carrier squelch between voice (≤ ~0.15 rms at ≤5 kHz deviation) and
    # the no-carrier noise; the mean in XLA's order
    inv = torch.tensor(1.0 / d.shape[-1], dtype=torch.float32, device=dev)
    p = torch.sqrt(tree_sum(d * d) * inv)[:, None]
    open_ = (p < SQUELCH_RMS).to(torch.float32)
    vb = torch.as_tensor(firdes.lowpass_taps(64, fs, 3400.0), device=dev)
    a = fir_real(d, vb) * open_
    pcm = resample(a, int(fs), 8000)
    return (pcm * 0.8).to(torch.float32)


class BatchedAnalogVoicePipeline:
    """``decode_block([C, B])`` → ``[C, T]`` 8 kHz PCM on ``device`` (the
    card when none is given; raises when there is none); the interface
    the trunked fleet needs of a voice pipeline."""

    def __init__(self, C: int, fs: float = 48000.0, pcm_fmt: str = "f16",
                 sync_threshold: float = 0.0, *, device=None):
        if device is None:
            device = require_cuda()
        self.device = torch.empty(0, device=device).device
        self.C = C
        self.fs = fs
        self.pcm_fmt = pcm_fmt

    def decode_block(self, iq) -> np.ndarray:
        """``iq``: ``[C, B]`` complex or ``[C, B, 2]`` float32 planes, a
        host array or a tensor."""
        if isinstance(iq, np.ndarray):
            if np.iscomplexobj(iq):
                iq = np.stack([iq.real, iq.imag],
                              axis=-1).astype(np.float32)
            iq = torch.from_numpy(np.ascontiguousarray(iq))
        x = iq.to(self.device)
        return analog_voice_decode(x, fs=self.fs).cpu().numpy()

    def reset_voice_state(self, channels=None) -> None:
        """Analog rows carry no synthesis state between blocks."""
