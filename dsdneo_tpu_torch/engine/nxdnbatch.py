"""Batched NXDN48 / NXDN96 voice: I/Q → PCM on the card.

Counterpart of ``dsdneo_tpu/engine/nxdnbatch.py``.  NXDN frames carry
their 10-symbol FSW every 192 dibits; an accepted hit is one 80 ms frame
of four AMBE+2 frames at dibits 38 + 36k of the PN9-descrambled payload.
Per ``[C, B]`` block:

  1. front end (kernel K1) and the ±FSW sync filter, the top
     ``SYNC_TOPK`` candidates per channel (a stable sort), and each
     candidate's LICH byte (the high bits of the 8 dibits after the
     FSW, descrambled and polarity-corrected), on the card;
  2. on the host: ``pick_frames`` (a copy of the JAX package's) keeps
     candidates over the score threshold whose LICH is parity-valid and
     full-voice, with the 188-dibit stride rule run greedily over all
     channels at once;
  3. :func:`nxdn_voice_decode_gather`: frame gather, polarity and PN9
     descramble, AMBE ECC, dequantization and the AMBE tail
     (``scatter_repeat_synth``, kernel K3 for ADPCM).

NXDN48 (2400 symbols/s, 6.25 kHz channel filter) and NXDN96 (4800,
12.5 kHz) share the frame geometry, the LICH conventions and the
payload layout: only the tables' front end differs.  Only the high bit
of a dibit is the sign, so an inverted sync and a scramble position
flip it (``^ 2``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.device import require_cuda, to_host
from dsdneo_tpu_torch.engine.batched import frontend_step
from dsdneo_tpu_torch.engine.dmrbatch import _dibits_to_bits
from dsdneo_tpu_torch.engine.voicebatch import correlate_syncs_device
from dsdneo_tpu_torch.engine.voicestate import VoiceCarryMixin
from dsdneo_tpu_torch.fec.device import ambe_ecc_batch
from dsdneo_tpu_torch.ops.audio_wire import wire_expand
from dsdneo_tpu_torch.vocoder.device import (ambe_params_gated,
                                             scatter_repeat_synth,
                                             voice_state_init)

FRAME_DIBITS = 192              # FSW(10) + LICH(8) + payload
_FULL_VOICE_LICH = {0x36, 0x37, 0x56, 0x57}


def _lich_parity_ok(lich_full: int) -> bool:
    """The NXDN decoder's LICH parity convention."""
    lich = lich_full >> 1
    nbits = 7 if lich in (0x08, 0x4A, 0x48, 0x46) else 4
    parity = 0
    for k in range(7, 8 - nbits, -1):
        parity ^= (lich_full >> k) & 1
    return parity == (lich_full & 1)


# parity-valid AND full-voice profile, over all 256 LICH byte values
_LICH_FULL_VOICE_LUT = np.asarray(
    [_lich_parity_ok(v) and (v >> 1) in _FULL_VOICE_LICH
     for v in range(256)], dtype=bool)


def _voice_tables(pn9_positions: np.ndarray):
    """(``[144]`` dibit offsets of the four AMBE frames from the FSW
    start, ``[144]`` descramble flip mask): payload dibit p sits at
    sync + 10 + p and flips when p is a PN9 scramble position."""
    scram = np.zeros(182, dtype=np.uint8)
    scram[pn9_positions] = 1
    p = 38 + np.arange(144)
    return (10 + p).astype(np.int64), scram[p]


class NxdnDecodeOut(NamedTuple):
    pcm: torch.Tensor       # wire format: f16 [C, T, 160], uint8 otherwise
    state: tuple            # (synthesis carry, frame-repeat carry)
    bits49: torch.Tensor    # [4F, 49] decoded parameter bits
    errs: torch.Tensor      # [4F] ECC error counts


def nxdn_voice_decode_gather(dibits, f_ch, f_pos, f_inv, offs, flips, fch,
                             forder, C: int, n_steps: int, tables,
                             pcm_fmt: str = "f16", state=None
                             ) -> NxdnDecodeOut:
    """Frame gather + descramble → AMBE ECC → dequant → scatter →
    repeat gate → synthesis.  Pad frames use ``f_ch == C``; ``f_inv``
    flags inverted-polarity hits.  ``state`` is the (synthesis, repeat)
    carry of the previous block."""
    Tn = dibits.shape[1]
    pos = torch.clamp(f_pos[:, None] + offs[None], 0, Tn - 1)  # [Fp, 144]
    ch = torch.clamp(f_ch, max=dibits.shape[0] - 1)
    dd = dibits[ch[:, None], pos]
    dd = dd ^ (f_inv[:, None] * 2).to(dd.dtype) ^ (flips[None] * 2)
    bits49, errs = ambe_ecc_batch(_dibits_to_bits(dd.reshape(-1, 36)),
                                  tables)
    w0, voiced, amps, good = ambe_params_gated(bits49, errs, tables)
    if state is None:
        state = voice_state_init(C, dibits.device)
    wire, state = scatter_repeat_synth(w0, voiced, amps, good, fch, forder,
                                       C, n_steps, state, pcm_fmt, tables)
    return NxdnDecodeOut(wire, state, bits49, errs)


class BatchedNxdnVoicePipeline(VoiceCarryMixin):
    """Drives the batched NXDN voice chain (``mode`` ``"nxdn48"`` or
    ``"nxdn96"``) over ``[C, B, 2]`` float32 I/Q blocks on ``device``
    (the card when none is given; raises when there is no card)."""

    SYNC_NAMES = ("+NXDN FSW", "-NXDN FSW")
    SYNC_TOPK = 128

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.55, pcm_fmt: str = "f16",
                 mode: str = "nxdn48", *, device=None,
                 tables: params.TdmaTables | None = None):
        # the 10-symbol FSW is short, so its correlation is only a
        # pre-filter; acceptance needs a parity-valid full-voice LICH
        if pcm_fmt not in ("f16", "adpcm", "mulaw"):
            raise ValueError(f"unknown pcm_fmt {pcm_fmt!r}")
        if mode not in ("nxdn48", "nxdn96"):
            raise ValueError(f"unknown NXDN mode {mode!r}")
        if device is None:
            device = require_cuda()
        self.tables = tables if tables is not None else params.load_tdma(
            mode, device)
        if self.tables.mode != mode:
            raise ValueError(f"tables of {self.tables.mode!r} for a "
                             f"{mode!r} pipeline")
        self.device = torch.empty(0, device=device).device
        if self.tables.taps.device != self.device:
            raise ValueError("tables live on another device than the "
                             "pipeline")
        self.C = C
        self.fs = fs
        self.mode = mode
        self.sps = fs / self.tables.symbol_rate
        self.threshold = sync_threshold
        self.pcm_fmt = pcm_fmt
        pn9 = self.tables.np["nxdn_pn9_positions"]
        offs, flips = _voice_tables(pn9)
        self._offs = torch.as_tensor(offs, device=self.device)
        self._flips = torch.as_tensor(flips, device=self.device)
        lich_flip = np.isin(np.arange(8), pn9).astype(np.uint8) * 2
        self._lich_flip = torch.as_tensor(lich_flip, device=self.device)
        self._lich_w = torch.tensor([1 << (7 - i) for i in range(8)],
                                    device=self.device)
        self.last_frames = None
        self.last_steps = None

    # -- front end + sync + LICH -----------------------------------------------
    def frontend_dispatch(self, iq):
        """Queue the front end, sync filter and LICH gather of one block:
        returns the device handle (dibits, idx, vq, dq, lich, n_sym)."""
        x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        n_sym = int(x.shape[1] // self.sps) - 2
        t = self.tables
        dibits, soft, _power = frontend_step(x, t.taps, self.sps, n_sym,
                                             t.four_level)
        sc = correlate_syncs_device(soft, t.sync_levels)
        best_def = torch.argmax(sc, dim=1).to(torch.uint8)
        bs = torch.amax(sc, dim=1)
        k_cand = min(self.SYNC_TOPK, n_sym - t.sync_len + 1)
        vals, idx = torch.sort(bs, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k_cand], idx[:, :k_cand]
        vq = torch.clamp(vals * 127.0, 0, 255).to(torch.uint8)
        dq = torch.gather(best_def, 1, idx)
        Cn, Tn = dibits.shape
        gp = torch.clamp(idx[:, :, None] + 10
                         + torch.arange(8, device=self.device), 0, Tn - 1)
        dd = dibits[torch.arange(Cn, device=self.device)[:, None, None], gp]
        dd = dd ^ ((dq & 1) * 2)[:, :, None] ^ self._lich_flip
        lich = (((dd >> 1) & 1) * self._lich_w).sum(-1).to(torch.uint8)
        return dibits, idx, vq, dq, lich, n_sym

    def frontend_finish(self, fe, cofetch=None):
        """Copy a dispatch's candidates to the host: (dibits_dev, idx
        int64, vq, dq, lich uint8, n_sym).
        ``cofetch``: a tensor or a tuple of them (a voice wire, say),
        copied to the host with the candidates; then returns (that tuple,
        them as numpy), as the JAX package's ``device_get`` does."""
        dibits, idx, vq, dq, lich, n_sym = fe
        out = (dibits, idx.cpu().numpy().astype(np.int64),
               vq.cpu().numpy(), dq.cpu().numpy(), lich.cpu().numpy(),
               n_sym)
        return out if cofetch is None else (out, to_host(cofetch))

    def frontend_sync_device(self, iq):
        """Front end, sync filter and LICH gather with the candidates on
        the host and the dibits left on the device."""
        return self.frontend_finish(self.frontend_dispatch(iq))

    # -- host frame picker ---------------------------------------------------------
    def pick_frames(self, idx, vq, dq, lich, n_sym: int):
        """FSW hits → accepted full-voice frames (channel, position,
        inverted) and the channel / step of each of their 4 AMBE frames.
        The gates (threshold, LICH parity and profile, bounds) are
        elementwise; the one sequential rule, a frame starts ≥ 188
        dibits after the last accepted one, runs as a greedy over the
        candidates in position order, all channels at once."""
        inv_lut = np.asarray(self.tables.sync_inverted, dtype=np.int32)
        C, k = idx.shape
        valid = ((vq.astype(np.float32) / 127.0 >= self.threshold)
                 & _LICH_FULL_VOICE_LUT[lich]
                 & (idx + FRAME_DIBITS < n_sym))
        BIG = np.int64(1) << 40
        pos = np.where(valid, idx, BIG)
        order = np.argsort(pos, axis=1, kind="stable")
        pos = np.take_along_axis(pos, order, axis=1)
        dq_s = np.take_along_axis(dq, order, axis=1)
        keep = np.zeros((C, k), dtype=bool)
        last = np.full(C, -10 ** 9, dtype=np.int64)
        for j in range(k):
            acc = (pos[:, j] < BIG) & (pos[:, j] - last >= FRAME_DIBITS - 4)
            keep[:, j] = acc
            last = np.where(acc, pos[:, j], last)
        cc, ss = np.nonzero(keep)
        acc_c = cc.astype(np.int32)
        acc_t = pos[cc, ss].astype(np.int32)
        acc_i = inv_lut[dq_s[cc, ss]]
        counts = keep.sum(axis=1)
        starts = np.zeros(C, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rank = np.arange(len(cc), dtype=np.int64) - starts[cc]
        fch = np.repeat(cc.astype(np.int64), 4)
        forder = (4 * rank[:, None]
                  + np.arange(4, dtype=np.int64)).reshape(-1)
        return acc_c, acc_t, acc_i, fch, forder

    # -- voice decode ------------------------------------------------------------
    def decode_block(self, iq) -> np.ndarray:
        """Full chain for one block → ``[C, n_frames·160]`` float32 PCM."""
        return self.fetch_pcm(self.decode_block_async(iq))

    def decode_block_async(self, iq):
        """Dispatch the full chain; returns the wire-format PCM tensor on
        the device without copying it to the host."""
        return self.decode_from_frontend(self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe6):
        """Pick frames from a finished front end and dispatch the voice
        decode; keeps the synthesis and repeat carries on the device."""
        dibits_dev, idx, vq, dq, lich, n_sym = fe6
        ac, at, ai, fch, forder = self.pick_frames(idx, vq, dq, lich, n_sym)
        F = ac.shape[0]
        if F == 0:
            self.last_frames = None
            self.last_steps = None
            return None
        n_steps = int(forder.max()) + 1
        # shape buckets, as the JAX package pads them: frames to 32s,
        # steps to 16s; pad frames go to row C
        Fp = -(-F // 32) * 32
        Tp = -(-n_steps // 16) * 16

        def padded(a, n, fill):
            out = np.full(n, fill, dtype=np.int64)
            out[:a.shape[0]] = a
            return torch.as_tensor(out, device=self.device)

        out = nxdn_voice_decode_gather(
            dibits_dev, padded(ac, Fp, self.C), padded(at, Fp, 0),
            padded(ai, Fp, 0), self._offs, self._flips,
            padded(fch, Fp * 4, self.C), padded(forder, Fp * 4, 0), self.C,
            Tp, self.tables, pcm_fmt=self.pcm_fmt, state=self._vstate)
        self._vstate = out.state
        # what was decoded, for checks: the real frames' bits and counts
        # with their channel and step, the accepted frames, the steps
        self.last_frames = (out.bits49[:F * 4], out.errs[:F * 4], fch,
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
