"""Batched YSF V/D2 voice: I/Q → PCM on the card.

Counterpart of ``dsdneo_tpu/engine/ysfbatch.py``.  System Fusion's DN
(V/D2) mode carries 5 AMBE+2 frames in every 480-dibit frame (sync 20,
FICH 100, five blocks of 20 data and 52 voice dibits).  Each 52-dibit
voice block de-interleaves (4 × 26), is dewhitened by the PN95 sequence
and majority-votes the tripled 27-bit protected prefix into a 49-bit
AMBE frame.  Per ``[C, B]`` block:

  1. the gated front end (``engine.demod.gated_frontend_step``, 4-level)
     and the ``+YSF`` correlation over the soft symbols clipped to ±3.5
     (a dead-air spike the power gate missed would otherwise crowd the
     list), the top ``SYNC_TOPK`` positions (a stable descending sort:
     ties keep the lower index, as ``jax.lax.top_k`` does), on the card;
  2. on the host: :meth:`BatchedYsfVoicePipeline.pick_frames` (the JAX
     package's): score threshold, 480-dibit spacing with the best score
     of an 8-position shoulder; every frame expands to 5 AMBE steps;
  3. :func:`ysf_voice_decode_gather`: the V/D2 gather, de-interleave,
     PN mask and vote, and the AMBE tail with the vote count as the
     gate (``ambe_params_gated(..., thr=VOTE_ERR_MAX)``: clean voice
     votes near unanimously, data frames and noise disagree on most
     triplets and are muted), synthesis and kernel K3 for ADPCM.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.device import require_cuda, to_host
from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.engine.demod import gated_frontend_step
from dsdneo_tpu_torch.engine.modes import MODES
from dsdneo_tpu_torch.engine.voicebatch import correlate_syncs_device
from dsdneo_tpu_torch.engine.voicestate import VoiceCarryMixin
from dsdneo_tpu_torch.ops.audio_wire import wire_expand
from dsdneo_tpu_torch.symbols.framesync import sync_levels
from dsdneo_tpu_torch.vocoder.device import (ambe_params_gated,
                                             scatter_repeat_synth,
                                             voice_state_init)

FRAME_DIBITS = 480              # sync 20 + FICH 100 + payload 360
VOTE_ERR_MAX = 5                # ≤ 5 disagreeing triplets of 27 = voice
PN95_SEED = 0x1C9


def pn95_bits(n: int) -> np.ndarray:
    """The first ``n`` bits of the YSF PN95 whitening sequence (the 9-bit
    LFSR of ``protocol/ysf/decoder.py``)."""
    lfsr = PN95_SEED
    out = np.zeros(n, dtype=np.uint8)
    for i in range(n):
        out[i] = lfsr & 1
        fb = ((lfsr >> 4) ^ lfsr) & 1
        lfsr = (lfsr >> 1) | (fb << 8)
    return out


@lru_cache(maxsize=1)
def _vd2_tables():
    """(``[5, 52]`` dibit offsets of the voice blocks from the sync
    start, the de-interleave gather ``[104]`` — ``bits[i] = raw[inv[i]]``
    — and the PN mask ``[104]``), numpy."""
    offs = 120 + 72 * np.arange(5)[:, None] + 20 + np.arange(52)[None]
    out_idx = (np.arange(104) % 4) * 26 + np.arange(104) // 4
    inv = np.argsort(out_idx)
    return (offs.astype(np.int64), inv.astype(np.int64),
            pn95_bits(104))


@lru_cache(maxsize=8)
def _consts(device: str) -> dict[str, torch.Tensor]:
    offs, inv, pn = _vd2_tables()
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {"offs": on(offs), "inv": on(inv), "pn": on(pn)}


def ysf_voice_bits(dibits: torch.Tensor, f_ch: torch.Tensor,
                   f_pos: torch.Tensor):
    """``[F]`` frames (channel, sync position; pad channel ``C``) →
    (``[5F, 49]`` uint8 AMBE bits, ``[5F]`` int32 vote disagreements):
    the V/D2 gather, de-interleave, PN mask and the tripled majority
    vote, in the frames' order."""
    k = _consts(str(dibits.device))
    Tn = dibits.shape[1]
    pos = torch.clamp(f_pos[:, None, None] + k["offs"][None], 0, Tn - 1)
    ch = torch.clamp(f_ch, max=dibits.shape[0] - 1)
    dd = dibits[ch[:, None, None], pos].reshape(-1, 52)      # [5F, 52]
    raw = torch.stack([(dd >> 1) & 1, dd & 1], dim=-1).reshape(-1, 104)
    bits = raw.to(torch.uint8)[:, k["inv"]] ^ k["pn"]
    s = bits[:, :81].reshape(-1, 27, 3).to(torch.int32).sum(dim=-1)
    ambe = torch.cat([(s >= 2).to(torch.uint8), bits[:, 81:103]], dim=1)
    return ambe, ((s != 0) & (s != 3)).sum(dim=-1).to(torch.int32)


class YsfDecodeOut(NamedTuple):
    pcm: torch.Tensor       # wire format: f16 [C, T, 160], uint8 otherwise
    state: tuple            # (synthesis carry, frame-repeat carry)
    bits49: torch.Tensor    # [5F, 49] voted AMBE bits
    errs: torch.Tensor      # [5F] vote disagreements


def ysf_voice_decode_gather(dibits, f_ch, f_pos, fch, forder, C: int,
                            n_steps: int, tables, pcm_fmt: str = "f16",
                            state=None) -> YsfDecodeOut:
    """V/D2 gather and vote → AMBE dequantization (vote-gated) → scatter
    → repeat gate → synthesis.  ``f_pos`` is a frame's sync position;
    each frame expands to 5 AMBE steps (``fch`` / ``forder`` are per
    AMBE frame); ``tables`` is the AMBE core (``params.DmrTables``);
    ``state`` the (synthesis, repeat) carry of the previous block."""
    ambe, verr = ysf_voice_bits(dibits, f_ch, f_pos)
    w0, voiced, amps, good = ambe_params_gated(ambe, verr, tables,
                                               thr=VOTE_ERR_MAX)
    if state is None:
        state = voice_state_init(C, dibits.device)
    wire, state = scatter_repeat_synth(w0, voiced, amps, good, fch, forder,
                                       C, n_steps, state, pcm_fmt, tables)
    return YsfDecodeOut(wire, state, ambe, verr)


class BatchedYsfVoicePipeline(VoiceCarryMixin):
    """Drives the batched YSF V/D2 chain over ``[C, B, 2]`` float32 I/Q
    blocks on ``device`` (the card when none is given; raises when there
    is no card)."""

    SYNC_NAMES = ("+YSF",)
    SYNC_TOPK = 64              # 10 frames/s + shoulders

    # off-air YSF deviation compresses the soft symbols, so the 20-dibit
    # sync correlates ~0.59; the correlation is only a pre-filter here,
    # acceptance is the per-frame majority-vote gate
    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.5, pcm_fmt: str = "f16", *,
                 device=None, tables: params.BurstTables | None = None):
        if pcm_fmt not in ("f16", "adpcm", "mulaw"):
            raise ValueError(f"unknown pcm_fmt {pcm_fmt!r}")
        if device is None:
            device = require_cuda()
        self.tables = (tables if tables is not None
                       else params.load_burst("ysf", device))
        if self.tables.kind != "ysf":
            raise ValueError(f"tables of {self.tables.kind!r} for a YSF "
                             "pipeline")
        self.device = self.tables.device
        self.C = C
        self.fs = fs
        self.mode = MODES["ysf"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = torch.as_tensor(firdes.channel_lpf(fs,
                                                       self.mode.lpf_profile),
                                    device=self.device)
        self.levels = torch.as_tensor(sync_levels(self.SYNC_NAMES),
                                      device=self.device)
        self.threshold = sync_threshold
        self.pcm_fmt = pcm_fmt
        self.last_frames = None
        self.last_steps = None

    # -- front end: gated demod + clipped correlation ---------------------
    def frontend_dispatch(self, iq):
        """Queue the front end and the sync filter of one block: returns
        the device handle (dibits, idx, vq, n_sym)."""
        x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        n_sym = int(x.shape[1] // self.sps) - 2
        dibits, soft = gated_frontend_step(x, self.taps, self.sps, n_sym,
                                           self.mode.four_level)
        sc = correlate_syncs_device(torch.clamp(soft, -3.5, 3.5),
                                    self.levels)
        bs = torch.amax(sc, dim=1)
        k = min(self.SYNC_TOPK, bs.shape[1])
        vals, idx = torch.sort(bs, dim=1, descending=True, stable=True)
        vq = torch.clamp(vals[:, :k] * 127.0, 0, 255).to(torch.uint8)
        return dibits, idx[:, :k], vq, n_sym

    def frontend_finish(self, fe, cofetch=None):
        """Copy a dispatch's candidates to the host: (dibits_dev, idx
        int64, vq uint8, n_sym).
        ``cofetch``: a tensor or a tuple of them (a voice wire, say),
        copied to the host with the candidates; then returns (that tuple,
        them as numpy), as the JAX package's ``device_get`` does."""
        dibits, idx, vq, n_sym = fe
        out = (dibits, idx.cpu().numpy().astype(np.int64), vq.cpu().numpy(),
               n_sym)
        return out if cofetch is None else (out, to_host(cofetch))

    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    # -- host frame picker ------------------------------------------------
    def pick_frames(self, idx, vq, n_sym: int):
        """Score threshold + 480-dibit spacing with the best score of an
        8-position shoulder (a ±1 sync offset garbles the whole V/D2
        extraction); every accepted frame expands to 5 AMBE steps.
        Returns (channels, positions, fch, forder)."""
        acc_c, acc_t, fch, forder = [], [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            scores = sc[ok][order]
            last = -10 ** 9
            n_ord = 0
            j = 0
            while j < len(positions):
                t = int(positions[j])
                if t - last < FRAME_DIBITS - 8 \
                        or t + FRAME_DIBITS >= n_sym:
                    j += 1
                    continue
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                j = k
                if t + FRAME_DIBITS >= n_sym:
                    # the refined winner (up to +7) can cross the end
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t)
                fch.extend([c] * 5)
                forder.extend(range(n_ord, n_ord + 5))
                n_ord += 5
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(fch, np.int64), np.asarray(forder, np.int64))

    # -- voice decode -----------------------------------------------------
    def decode_block(self, iq) -> np.ndarray:
        """Full chain for one block → ``[C, n_steps·160]`` float32 PCM."""
        return self.fetch_pcm(self.decode_block_async(iq))

    def decode_block_async(self, iq):
        """Dispatch the full chain; returns the wire-format PCM tensor on
        the device without copying it to the host."""
        return self.decode_from_frontend(self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe4):
        """Pick frames from a finished front end and dispatch the voice
        decode; keeps the synthesis and repeat carries on the device."""
        dibits_dev, idx, vq, n_sym = fe4
        ac, at, fch, forder = self.pick_frames(idx, vq, n_sym)
        F = ac.shape[0]
        if F == 0:
            self.last_frames = None
            self.last_steps = None
            return None
        n_steps = int(forder.max()) + 1
        # shape buckets, as the JAX package pads them: frames to 16s,
        # steps to 20s; pad frames go to row C
        Fp = -(-F // 16) * 16
        Tp = -(-n_steps // 20) * 20

        def padded(a, n, fill):
            out = np.full(n, fill, dtype=np.int64)
            out[:a.shape[0]] = a
            return torch.as_tensor(out, device=self.device)

        out = ysf_voice_decode_gather(
            dibits_dev, padded(ac, Fp, self.C), padded(at, Fp, 0),
            padded(fch, Fp * 5, self.C), padded(forder, Fp * 5, 0), self.C,
            Tp, self.tables.ambe, pcm_fmt=self.pcm_fmt, state=self._vstate)
        self._vstate = out.state
        # what was decoded, for checks: the real frames' bits and vote
        # counts with their channel and step, the accepted frames
        self.last_frames = (out.bits49[:F * 5], out.errs[:F * 5], fch,
                            forder, (ac, at))
        self.last_steps = Tp
        return out.pcm

    def fetch_pcm(self, handle) -> np.ndarray:
        """Copy a ``decode_block_async`` result (or the host copy a
        ``cofetch`` made of it) to the host and expand it to ``[C, N]``
        float32 PCM."""
        if handle is None:
            return np.zeros((self.C, 0), dtype=np.float32)
        return wire_expand(to_host(handle), self.pcm_fmt, self.C)

    def decode_block_bits49(self, iq):
        """Parity hook: the voted 49-bit AMBE frames and their vote
        disagreements in dispatch order (5 per accepted frame)."""
        dibits_dev, idx, vq, n_sym = self.frontend_sync_device(iq)
        ac, at, _fch, _ford = self.pick_frames(idx, vq, n_sym)
        if ac.size == 0:
            return np.zeros((0, 49), np.uint8), np.zeros(0, np.int64)
        ambe, verr = ysf_voice_bits(
            dibits_dev, torch.as_tensor(ac.astype(np.int64),
                                        device=self.device),
            torch.as_tensor(at.astype(np.int64), device=self.device))
        return ambe.cpu().numpy(), verr.cpu().numpy().astype(np.int64)
