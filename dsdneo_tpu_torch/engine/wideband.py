"""Wideband multi-channel decode: one wideband I/Q capture → every active
narrowband channel decoded.

Counterpart of ``dsdneo_tpu/engine/wideband.py``.  The whole band is
channelized in one pass (the 2x-oversampled polyphase bank,
``dsp.channelizer.channelize_os2``, and a halfband decimator give clean
48 kHz basebands without the channel-edge aliasing of a critically
sampled bank), then either every channel that carries power goes
through the serial ``decode_samples`` (:func:`decode_wideband`), or
every channel stays on the device and runs the batched P25 voice chain
(:func:`decode_wideband_voice_batched`).  Each entry point takes the
card unless given ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from dsdneo_tpu_torch.device import require_cuda
from dsdneo_tpu_torch.dsp import frontend
from dsdneo_tpu_torch.dsp.channelizer import (channel_frequencies, channelize,
                                              channelize_os2)
from dsdneo_tpu_torch.engine.decoder import decode_samples
from dsdneo_tpu_torch.engine.fleettrunk import halfband_taps
from dsdneo_tpu_torch.protocol import base as proto_base
from dsdneo_tpu_torch.runtime import handoff, trace

CHANNEL_RATE = 48000.0


@dataclass
class ChannelResult:
    index: int
    freq_hz: float                 # signed offset from band center
    power_db: float
    ctx: proto_base.DecoderContext = field(repr=False)


def _n_channels(fs: float, n_ch: int | None) -> int:
    if n_ch is None:
        n_ch = int(round(fs / CHANNEL_RATE))
    if n_ch < 2:
        # n_ch == 1 would make the os2 decimator degenerate (d = 0) and
        # emit a sample-doubled stream labelled 48 kHz
        raise ValueError(f"wideband decode needs fs >= 96 kHz (fs={fs:g})")
    if abs(fs - n_ch * CHANNEL_RATE) > 1.0:
        raise ValueError(
            f"sample rate {fs:g} is not a multiple of 48 kHz "
            f"({n_ch} channels would need {n_ch * CHANNEL_RATE:g})")
    return n_ch


def _complex_on(samples, dev, block: int | None = None) -> torch.Tensor:
    """A wideband block (``[B]`` complex or ``[B, 2]`` float32 planes, a
    host array or a tensor) as a complex64 tensor on ``dev``, a pinned
    block copied without blocking the host (``runtime.handoff.to_card``);
    the tracer's span ``band.h2d`` of ``block``."""
    with trace.span("band.h2d", block):
        x = samples
        if isinstance(x, np.ndarray):
            if np.iscomplexobj(x):
                # complex host blocks travel as float32 planes
                x = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
            x = torch.from_numpy(np.ascontiguousarray(x))
        x, _ = handoff.to_card(x, dev)
        if not x.is_complex():
            x = torch.complex(x[..., 0].contiguous(),
                              x[..., 1].contiguous())
        return x.to(torch.complex64)


def channelize_band_device(samples, fs: float, n_ch: int | None = None,
                           *, device=None, block: int | None = None):
    """The band's ``[n_ch, B']`` 48 kHz basebands as a complex64 tensor on
    the device (for the batched pipelines to take in place), and the
    channel centre offsets in Hz.  ``block``: the number the band's
    block carries in the tracer's spans."""
    n_ch = _n_channels(fs, n_ch)
    dev = require_cuda() if device is None else device
    x = _complex_on(samples, dev, block)
    ch2 = channelize_os2(x, n_ch, taps_per_branch=12)
    return (frontend.decimate2_halfband(ch2, _halfband(x.device))
            .contiguous(),
            channel_frequencies(n_ch, fs))


@lru_cache(maxsize=None)
def _halfband(device) -> torch.Tensor:
    """The halfband's taps on ``device``, made once per device."""
    return torch.as_tensor(halfband_taps(), device=device)


def channelize_band(samples, fs: float, n_ch: int | None = None,
                    oversampled: bool = True, *, device=None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Wideband complex ``[B]`` → (``[n_ch, B']`` complex64 48 kHz
    basebands on the host, channel centre offsets in Hz)."""
    n_ch = _n_channels(fs, n_ch)
    dev = require_cuda() if device is None else device
    if oversampled:
        ch, freqs = channelize_band_device(samples, fs, n_ch, device=dev)
    else:
        ch = channelize(_complex_on(samples, dev), n_ch, taps_per_branch=12)
        freqs = channel_frequencies(n_ch, fs)
    return ch.cpu().numpy().astype(np.complex64), freqs


def decode_wideband(samples, fs: float, mode="auto",
                    n_ch: int | None = None, oversampled: bool = True,
                    power_gate_db: float = -20.0, *, device=None,
                    **decode_kw) -> list[ChannelResult]:
    """Channelize a wideband capture and decode every active channel
    with ``decode_samples`` (``mode="auto"`` detects each).

    ``power_gate_db``: channels whose mean power is more than this far
    below the strongest channel are skipped (dead air)."""
    dev = require_cuda() if device is None else device
    ch, freqs = channelize_band(samples, fs, n_ch, oversampled, device=dev)
    pw = (np.abs(ch) ** 2).mean(axis=-1)
    ref = float(pw.max())
    if ref <= 0:
        return []
    gate = ref * 10.0 ** (power_gate_db / 10.0)
    out: list[ChannelResult] = []
    for k in np.argsort(freqs):
        if pw[k] < gate or pw[k] < 1e-9:
            continue
        ctx = decode_samples(ch[k], mode, fs=CHANNEL_RATE, device=dev,
                             **decode_kw)
        out.append(ChannelResult(index=int(k), freq_hz=float(freqs[k]),
                                 power_db=10.0 * np.log10(pw[k] / ref),
                                 ctx=ctx))
    return out


def decode_wideband_voice_batched(samples, fs: float,
                                  n_ch: int | None = None,
                                  sync_threshold: float = 0.62, *,
                                  pcm_fmt: str = "f16", pipe=None,
                                  device=None):
    """The wideband voice cell end to end on the device: the band
    channelized through the 2x-oversampled bank, every channel through
    the batched P25 voice chain, the basebands never on the host.
    ``pipe``: a ``BatchedP25VoicePipeline`` of ``n_ch`` channels from an
    earlier block, whose voice carry the next block continues.

    Returns (PCM ``[n_ch, T]`` float32, channel offsets in Hz)."""
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    dev = require_cuda() if device is None else device
    n_ch = _n_channels(fs, n_ch)
    if pipe is None:
        pipe = BatchedP25VoicePipeline(n_ch, fs=CHANNEL_RATE,
                                       sync_threshold=sync_threshold,
                                       pcm_fmt=pcm_fmt, device=dev)
    # the band serves the block the pipeline numbers next
    ch, freqs = channelize_band_device(samples, fs, n_ch, device=dev,
                                       block=pipe.blocks)
    return pipe.decode_block(torch.view_as_real(ch)), freqs
