"""Entry driver: ``engine.wideband.decode_wideband_voice_batched`` over a
wideband band, one block a call, one pipeline carried (the library entry
as it stands: synchronous per block).  A block is handed off at the
entry call, which copies the band from the host ring to the card, and
completes when the call returns its ``[n_ch, N]`` float32 PCM.
"""

from __future__ import annotations

import time

import torch

from dsdneo_tpu_torch.engine.wideband import (channelize_band_device,
                                              decode_wideband_voice_batched)
from portbench.entries.p25_pipelined import Entry as _P25Entry


class Entry(_P25Entry):
    """The per-channel entry's pipeline, carried, and what it samples;
    the band's own loop, split and basebands."""

    def k1_shape(self, block) -> tuple[int, int]:
        d = self.channels // 2
        m = (int(block.shape[0]) - d) // self.channels
        return self.channels, m            # 2m samples, halved

    def run(self, src, rec) -> None:
        cfg = self.cfg
        while (item := src.next()) is not None:
            seq, band = item
            self.last_block = band
            rec.handoff(seq)
            rec.before(seq, self)
            with rec.span("decode_wideband_voice_batched"):
                pcm, _freqs = decode_wideband_voice_batched(
                    band, cfg["band_fs"], self.channels,
                    pcm_fmt=cfg["pcm_fmt"], pipe=self.pipe,
                    device=self.device)
            rec.after(seq, self)
            rec.done(seq, pcm)

    def split(self, band) -> dict[str, float]:
        """The entry's stages one by one, each synchronized: the
        channelizer (with the band's copy to the card) timed by CUDA
        events, then the pipeline's as for per-channel blocks."""
        cuda = self.device.type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        out = {}
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        ch, _f = channelize_band_device(band, self.cfg["band_fs"],
                                        self.channels, device=self.device)
        if cuda:
            b.record()
            b.synchronize()
            out["channelizer"] = a.elapsed_time(b) / 1e3
        else:
            out["channelizer"] = time.perf_counter() - t0
        out.update(super().split(torch.view_as_real(ch)))
        return out

    def basebands(self, band):
        ch, _f = channelize_band_device(band, self.cfg["band_fs"],
                                        self.channels, device=self.device)
        return torch.view_as_real(ch)
