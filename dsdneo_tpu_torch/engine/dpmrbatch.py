"""Batched dPMR voice: I/Q → PCM on the card.

Counterpart of ``dsdneo_tpu/engine/dpmrbatch.py``.  dPMR (2400 symbols/s,
4-level, 6.25 kHz) sends voice in FS2 superframe parts of 384 dibits: the
12-dibit FS2 sync and two TCH groups of four 36-dibit AMBE+2 frames, at
48 + 36k and 240 + 36k from the sync start, not scrambled.  Per
``[C, B]`` block:

  1. the gated front end (``engine.demod.gated_frontend_step``, 4-level)
     and the ±FS2 correlation over the soft symbols clipped to ±3.5, the
     top ``SYNC_TOPK`` positions of the better pattern (a stable
     descending sort) with that pattern's index, on the card;
  2. on the host: :meth:`BatchedDpmrVoicePipeline.pick_parts` (the JAX
     package's): score threshold, 384-dibit spacing with the best score
     of an 8-position shoulder; pattern 1 (the inverted FS2) flips the
     polarity of the part;
  3. the device program is the NXDN one
     (``engine.nxdnbatch.nxdn_voice_decode_gather``) with dPMR's frame
     offsets and a zero flip mask: frame gather, AMBE ECC,
     dequantization, the AMBE tail and kernel K3 for ADPCM.
"""

from __future__ import annotations

import numpy as np
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.device import require_cuda, to_host
from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.engine.demod import gated_frontend_step
from dsdneo_tpu_torch.engine.modes import MODES
from dsdneo_tpu_torch.engine.nxdnbatch import nxdn_voice_decode_gather
from dsdneo_tpu_torch.engine.voicebatch import correlate_syncs_device
from dsdneo_tpu_torch.engine.voicestate import VoiceCarryMixin
from dsdneo_tpu_torch.ops.audio_wire import wire_expand
from dsdneo_tpu_torch.symbols.framesync import sync_levels

PART_DIBITS = 384               # FS2-to-FS2 stride (12 sync + 372 part)
FRAMES_PER_PART = 8


def _voice_offsets() -> np.ndarray:
    """``[8·36]`` dibit offsets of a part's AMBE frames from the FS2 sync
    start (the sync is 12 dibits; the groups start 36 dibits into each
    half of the part)."""
    offs = []
    for base in (12 + 36, 12 + 36 + 144 + 12 + 36):
        for k in range(4):
            offs.append(base + 36 * k + np.arange(36))
    return np.concatenate(offs).astype(np.int64)


class BatchedDpmrVoicePipeline(VoiceCarryMixin):
    """Drives the batched dPMR voice chain over ``[C, B, 2]`` float32 I/Q
    blocks on ``device`` (the card when none is given; raises when there
    is no card)."""

    SYNC_NAMES = ("+dPMR FS2", "-dPMR FS2")
    SYNC_TOPK = 64

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, pcm_fmt: str = "f16", *,
                 device=None, tables: params.BurstTables | None = None):
        if pcm_fmt not in ("f16", "adpcm", "mulaw"):
            raise ValueError(f"unknown pcm_fmt {pcm_fmt!r}")
        if device is None:
            device = require_cuda()
        self.tables = (tables if tables is not None
                       else params.load_burst("dpmr", device))
        if self.tables.kind != "dpmr":
            raise ValueError(f"tables of {self.tables.kind!r} for a dPMR "
                             "pipeline")
        self.device = self.tables.device
        self.C = C
        self.fs = fs
        self.mode = MODES["dpmr"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = torch.as_tensor(firdes.channel_lpf(fs,
                                                       self.mode.lpf_profile),
                                    device=self.device)
        self.levels = torch.as_tensor(sync_levels(self.SYNC_NAMES),
                                      device=self.device)
        self.threshold = sync_threshold
        self.pcm_fmt = pcm_fmt
        self._offs = torch.as_tensor(_voice_offsets(), device=self.device)
        self._flips = torch.zeros(FRAMES_PER_PART * 36, dtype=torch.uint8,
                                  device=self.device)
        self.last_frames = None
        self.last_steps = None

    # -- front end: gated demod + clipped correlation ---------------------
    def frontend_dispatch(self, iq):
        """Queue the front end and the sync filter of one block: returns
        the device handle (dibits, idx, vq, dq, n_sym); ``dq`` is the
        index of the better pattern at each candidate."""
        x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        n_sym = int(x.shape[1] // self.sps) - 2
        dibits, soft = gated_frontend_step(x, self.taps, self.sps, n_sym,
                                           self.mode.four_level)
        sc = correlate_syncs_device(torch.clamp(soft, -3.5, 3.5),
                                    self.levels)
        best_def = torch.argmax(sc, dim=1).to(torch.uint8)
        bs = torch.amax(sc, dim=1)
        k = min(self.SYNC_TOPK, bs.shape[1])
        vals, idx = torch.sort(bs, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        vq = torch.clamp(vals * 127.0, 0, 255).to(torch.uint8)
        return dibits, idx, vq, torch.gather(best_def, 1, idx), n_sym

    def frontend_finish(self, fe, cofetch=None):
        """Copy a dispatch's candidates to the host: (dibits_dev, idx
        int64, vq uint8, dq uint8, n_sym).
        ``cofetch``: a tensor or a tuple of them (a voice wire, say),
        copied to the host with the candidates; then returns (that tuple,
        them as numpy), as the JAX package's ``device_get`` does."""
        dibits, idx, vq, dq, n_sym = fe
        out = (dibits, idx.cpu().numpy().astype(np.int64), vq.cpu().numpy(),
               dq.cpu().numpy(), n_sym)
        return out if cofetch is None else (out, to_host(cofetch))

    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    # -- host part picker -------------------------------------------------
    def pick_parts(self, idx, vq, dq, n_sym: int):
        """Score threshold + 384-dibit spacing with the best score of an
        8-position shoulder; pattern 1 (inverted FS2) flips the dibit
        polarity.  Returns (channels, positions, inverted, fch,
        forder)."""
        acc_c, acc_t, acc_i, fch, forder = [], [], [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            scores = sc[ok][order]
            pdefs = dq[c][ok][order]
            last = -10 ** 9
            n_ord = 0
            j = 0
            while j < len(positions):
                t = int(positions[j])
                if t - last < PART_DIBITS - 8 \
                        or t + PART_DIBITS >= n_sym:
                    j += 1
                    continue
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                inv = int(pdefs[w]) & 1
                j = k
                if t + PART_DIBITS >= n_sym:
                    # the refined winner (up to +7) can cross the end
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t)
                acc_i.append(inv)
                fch.extend([c] * FRAMES_PER_PART)
                forder.extend(range(n_ord, n_ord + FRAMES_PER_PART))
                n_ord += FRAMES_PER_PART
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_i, np.int32),
                np.asarray(fch, np.int64), np.asarray(forder, np.int64))

    # -- voice decode -----------------------------------------------------
    def decode_block(self, iq) -> np.ndarray:
        """Full chain for one block → ``[C, n_steps·160]`` float32 PCM."""
        return self.fetch_pcm(self.decode_block_async(iq))

    def decode_block_async(self, iq):
        """Dispatch the full chain; returns the wire-format PCM tensor on
        the device without copying it to the host."""
        return self.decode_from_frontend(self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe5):
        """Pick parts from a finished front end and dispatch the voice
        decode; keeps the synthesis and repeat carries on the device."""
        dibits_dev, idx, vq, dq, n_sym = fe5
        ac, at, ai, fch, forder = self.pick_parts(idx, vq, dq, n_sym)
        F = ac.shape[0]
        if F == 0:
            self.last_frames = None
            self.last_steps = None
            return None
        n_steps = int(forder.max()) + 1
        # shape buckets, as the JAX package pads them: parts and steps to
        # 16s; pad parts go to row C
        Fp = -(-F // 16) * 16
        Tp = -(-n_steps // 16) * 16

        def padded(a, n, fill):
            out = np.full(n, fill, dtype=np.int64)
            out[:a.shape[0]] = a
            return torch.as_tensor(out, device=self.device)

        n_fr = FRAMES_PER_PART
        out = nxdn_voice_decode_gather(
            dibits_dev, padded(ac, Fp, self.C), padded(at, Fp, 0),
            padded(ai, Fp, 0), self._offs, self._flips,
            padded(fch, Fp * n_fr, self.C), padded(forder, Fp * n_fr, 0),
            self.C, Tp, self.tables.ambe, pcm_fmt=self.pcm_fmt,
            state=self._vstate)
        self._vstate = out.state
        # what was decoded, for checks: the real frames' bits and ECC
        # counts with their channel and step, the accepted parts
        self.last_frames = (out.bits49[:F * n_fr], out.errs[:F * n_fr], fch,
                            forder, (ac, at, ai))
        self.last_steps = Tp
        return out.pcm

    def fetch_pcm(self, handle) -> np.ndarray:
        """Copy a ``decode_block_async`` result (or the host copy a
        ``cofetch`` made of it) to the host and expand it to ``[C, N]``
        float32 PCM."""
        if handle is None:
            return np.zeros((self.C, 0), dtype=np.float32)
        return wire_expand(to_host(handle), self.pcm_fmt, self.C)
