"""Batched many-channel D-STAR event pipeline: I/Q → RF headers, slow-data
events and raw AMBE voice bits.

Counterpart of ``dsdneo_tpu/engine/dstarbatch.py``.  D-STAR (GMSK 4800
bps, 2-level) interleaves two frame kinds behind two 24-dibit syncs:

  - the RF header: 660 coded bits, descrambled (x⁷+x⁴+1 LFSR),
    de-interleaved (24-stride), decoded by the rate-1/2 K=3 Viterbi
    (``fec.device.conv_k3_decode_batch``, kernel K6 on the card) → 41
    octets with CRC-16/X25;
  - the voice superframe: 21 × 72 AMBE bits with 20 × 24 slow-data bits
    between them (the sync replaces the 21st data field); the slow data
    XOR-descrambles with the repeating 0x0EF2C9 pattern into 60 bytes,
    the AMBE frames run the D-STAR AMBE ECC
    (``fec.device.dstar_ambe_ecc_batch``).

Per block: the gated front end (``engine.demod.gated_frontend_step``,
2-level) and the two syncs' correlation over the clipped soft symbols,
the top ``SYNC_TOPK`` over the pattern-major flat scores (a stable
descending sort: ties keep the lower index, as ``jax.lax.top_k`` does);
the host pick (threshold, ±8 cluster refinement, the superframe chain
gate — a partner voice sync at ±2016 ± 2 dibits — and a schedule of
frames that do not overlap); the device decode of both kinds into byte
blobs; the host event lines.  A superframe without a partner in the
block is dropped by design; a header emits when its CRC holds or its
score reaches ``HD_SOLO_SCORE``.  There is no PCM: the AMBE parameters
stay VQ-coded, so events carry raw bits, the ECC-checked 49-bit
parameters and their error counts.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.device import require_cuda
from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.engine.demod import gated_frontend_step
from dsdneo_tpu_torch.engine.modes import MODES
from dsdneo_tpu_torch.engine.voicebatch import correlate_syncs_device
from dsdneo_tpu_torch.fec.device import (conv_k3_decode_batch,
                                         dstar_ambe_ecc_batch)
from dsdneo_tpu_torch.protocol.base import DecoderContext
from dsdneo_tpu_torch.protocol.dstar.decoder import (SD_SCRAMBLE,
                                                     _header_scramble,
                                                     header_line,
                                                     slow_data_line,
                                                     voicing_activity)
from dsdneo_tpu_torch.symbols.framesync import sync_levels

VOICE_EXTENT = 2016             # sync 24 + 21*72 voice + 20*24 slow data
HEADER_EXTENT = 684             # sync 24 + 660 coded header bits


@lru_cache(maxsize=1)
def _dstar_tables():
    """(the 660-bit header scramble, the inverse of the 24-stride header
    interleave as a gather ``dei = b[inv]``, the tiled 480-bit slow-data
    scramble), numpy."""
    scram = np.resize(_header_scramble(), 660).astype(np.uint8)
    dest = np.zeros(660, dtype=np.int64)
    k = 0
    for i in range(660):
        dest[i] = k
        k += 24
        if k >= 672:
            k -= 671
        elif k >= 660:
            k -= 647
    inv = np.argsort(dest)
    sd_scram = np.tile(SD_SCRAMBLE, 20).astype(np.uint8)
    return scram, inv, sd_scram


@lru_cache(maxsize=1)
def _voice_offsets():
    """Dibit offsets from the voice sync's start: ``[21, 72]`` voice and
    ``[20, 24]`` slow data (voice frame j at 24 + 96j, its data field
    after it)."""
    voff = 24 + 96 * np.arange(21)[:, None] + np.arange(72)[None]
    doff = 24 + 96 * np.arange(20)[:, None] + 72 + np.arange(24)[None]
    return voff, doff


@lru_cache(maxsize=8)
def _consts(device: str) -> dict[str, torch.Tensor]:
    """The static gathers and masks of both decoders on ``device``."""
    scram, inv, sd_scram = _dstar_tables()
    voff, doff = _voice_offsets()
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {"scram": on(scram), "inv": on(inv), "sd_scram": on(sd_scram),
            "hoff": on(24 + np.arange(660)), "voff": on(voff),
            "doff": on(doff),
            "lsb": on(np.array([1, 2, 4, 8, 16, 32, 64, 128], np.int32)),
            "msb": on(np.array([128, 64, 32, 16, 8, 4, 2, 1], np.int32))}


def _pack(bits: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``[..., 8k]`` 0/1 → ``[..., k]`` bytes with the bit ``weights``."""
    shp = bits.shape[:-1] + (bits.shape[-1] // 8, 8)
    return (bits.reshape(shp).to(torch.int32) * weights).sum(
        dim=-1).to(torch.uint8)


def _gather_bits(dibits: torch.Tensor, ch: torch.Tensor, pos: torch.Tensor,
                 offs: torch.Tensor) -> torch.Tensor:
    """``[F]`` (channel, sync position) × static offsets → 0/1 bits
    (2-level: dibit 3 → 1); positions clip to the block, pad channels
    (``ch == C``) read the last channel."""
    Tn = dibits.shape[1]
    gp = torch.clamp(pos.reshape(pos.shape + (1,) * offs.ndim) + offs[None],
                     0, Tn - 1)
    cc = torch.clamp(ch, max=dibits.shape[0] - 1)
    cc = cc.reshape(cc.shape + (1,) * offs.ndim)
    return ((dibits[cc, gp] >> 1) & 1).to(torch.uint8)


def dstar_header_decode_device(dibits: torch.Tensor, ch: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """``[F]`` header hits (``pos`` = sync start) → ``[F, 41]`` header
    octets: descramble, de-interleave, the K=3 Viterbi (kernel K6 on the
    card), pack least significant bit first."""
    k = _consts(str(dibits.device))
    bits = _gather_bits(dibits, ch, pos, k["hoff"])
    dei = (bits ^ k["scram"])[:, k["inv"]]
    info = conv_k3_decode_batch(dei)                          # [F, 330]
    return _pack(info[:, :328], k["lsb"])


def dstar_voice_decode_device(dibits: torch.Tensor, ch: torch.Tensor,
                              pos: torch.Tensor,
                              tables: params.EventTables) -> torch.Tensor:
    """``[F]`` superframe hits → uint8 blob ``[F, 417]``: 60 descrambled
    slow-data bytes | the 21 × 72 raw AMBE bits packed most significant
    bit first (189) | the 21 × 49 ECC-decoded parameter bits, each frame
    padded to 7 bytes (147) | the 21 frames' ECC error counts (21)."""
    k = _consts(str(dibits.device))
    F = ch.shape[0]
    vbits = _gather_bits(dibits, ch, pos, k["voff"])          # [F, 21, 72]
    sd = _gather_bits(dibits, ch, pos, k["doff"]).reshape(F, 480) \
        ^ k["sd_scram"]
    sd_bytes = _pack(sd, k["lsb"])                            # [F, 60]
    vbytes = _pack(vbits.reshape(F, 21 * 72), k["msb"])
    ambe, errs = dstar_ambe_ecc_batch(vbits.reshape(-1, 72), tables)
    ambe56 = torch.cat([ambe, torch.zeros((ambe.shape[0], 7),
                                          dtype=torch.uint8,
                                          device=ambe.device)], dim=1)
    abytes = _pack(ambe56, k["msb"]).reshape(F, 21 * 7)
    ebytes = torch.clamp(errs, max=255).to(torch.uint8).reshape(F, 21)
    return torch.cat([sd_bytes, vbytes, abytes, ebytes], dim=1)


class BatchedDstarPipeline:
    """Batched D-STAR monitor over ``[C, B, 2]`` float32 I/Q blocks on
    ``device`` (the card when none is given; raises when there is no
    card).  Events land in ``ctxs[c].events``."""

    SYNC_NAMES = ("+D-STAR", "+D-STAR HD")
    SYNC_TOPK = 64              # ~7 superframes + header per 3 s block
    CHAIN_TOL = 2               # ± dibits for the ±2016 partner check
    HD_SOLO_SCORE = 0.68        # header emit floor when its CRC fails

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.55, *, device=None,
                 tables: params.EventTables | None = None):
        if device is None:
            device = require_cuda()
        self.tables = (tables if tables is not None
                       else params.load_event("dstar", device))
        self.device = self.tables.device
        self.C = C
        self.fs = fs
        self.mode = MODES["dstar"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = torch.as_tensor(firdes.channel_lpf(fs,
                                                       self.mode.lpf_profile),
                                    device=self.device)
        self.levels = torch.as_tensor(sync_levels(self.SYNC_NAMES),
                                      device=self.device)
        self.threshold = sync_threshold
        self.ctxs = [DecoderContext() for _ in range(C)]
        self._active = [False] * C    # per-block voicing activity
        self.last_frames = None       # (ch, pos, kind, score, records)

    # -- front end: gated demod + clipped per-pattern correlation ---------
    def frontend_dispatch(self, iq):
        """Queue the front end and the sync filter of one block: returns
        the device handle (dibits, idx, vq, n_sym)."""
        x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        n_sym = int(x.shape[1] // self.sps) - 2
        dibits, soft = gated_frontend_step(x, self.taps, self.sps, n_sym,
                                           self.mode.four_level)
        sc = correlate_syncs_device(torch.clamp(soft, -3.5, 3.5),
                                    self.levels)              # [C, 2, T']
        flat = sc.reshape(sc.shape[0], -1)                    # pattern-major
        k = min(self.SYNC_TOPK, sc.shape[2])
        vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        vq = torch.clamp(vals[:, :k] * 127.0, 0, 255).to(torch.uint8)
        return dibits, idx[:, :k], vq, n_sym

    def frontend_finish(self, fe):
        """Copy a dispatch's candidates to the host: (dibits_dev, pattern
        0 = voice / 1 = header, position, vq, n_sym)."""
        dibits, idx, vq, n_sym = fe
        n_corr = n_sym - self.levels.shape[1] + 1
        flat = idx.cpu().numpy().astype(np.int64)
        return (dibits, (flat // n_corr).astype(np.int32), flat % n_corr,
                vq.cpu().numpy(), n_sym)

    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    def pick_frames(self, pat, pos, vq, n_sym: int):
        """Threshold pre-filter → ±8 local-max cluster refinement → voice
        superframe chain gate (a partner at ±2016 ± 2) → greedy schedule
        of frames that do not overlap.  Returns (ch, pos, kind, score)."""
        extent = {0: VOICE_EXTENT, 1: HEADER_EXTENT}
        acc_c, acc_t, acc_k, acc_s = [], [], [], []
        for c in range(pat.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(pos[c][ok], kind="stable")
            positions = pos[c][ok][order]
            kinds = pat[c][ok][order]
            scores = sc[ok][order]
            cand = []                       # (t, kind, score)
            j = 0
            while j < len(positions):
                t = int(positions[j])
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                cand.append((int(positions[w]), int(kinds[w]),
                             float(scores[w])))
                j = k
            vpos = np.asarray([t for t, kk, _ in cand if kk == 0])
            kept = []
            for t, kk, s in cand:
                if kk == 0:
                    d = np.abs(np.abs(vpos - t) - VOICE_EXTENT)
                    if not (d <= self.CHAIN_TOL).any():
                        continue
                kept.append((t, kk, s))
            last_end = -10 ** 9
            for t, kk, s in kept:
                if t < last_end or t + extent[kk] > n_sym:
                    continue
                last_end = t + extent[kk]
                acc_c.append(c)
                acc_t.append(t)
                acc_k.append(kk)
                acc_s.append(s)
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_k, np.int32), np.asarray(acc_s, np.float32))

    def decode_records(self, dibits_dev, ac, at, ak) -> list[np.ndarray]:
        """The device decode of accepted hits, both kinds, each padded to
        a multiple of 8 hits (pad channel ``C``): one record per hit, in
        the hits' order (417 bytes for a superframe, 41 for a header)."""
        blobs = {}
        for kind in (0, 1):
            sel = np.flatnonzero(ak == kind)
            if not sel.size:
                continue
            Fp = -(-sel.size // 8) * 8
            cc = np.full(Fp, self.C, dtype=np.int64)
            tt = np.zeros(Fp, dtype=np.int64)
            cc[:sel.size] = ac[sel]
            tt[:sel.size] = at[sel]
            cc_t = torch.as_tensor(cc, device=self.device)
            tt_t = torch.as_tensor(tt, device=self.device)
            blob = (dstar_voice_decode_device(dibits_dev, cc_t, tt_t,
                                              self.tables) if kind == 0
                    else dstar_header_decode_device(dibits_dev, cc_t, tt_t))
            blobs[kind] = blob.cpu().numpy()[:sel.size]
        counters = {0: 0, 1: 0}
        recs = []
        for k in ak.tolist():
            recs.append(blobs[k][counters[k]])
            counters[k] += 1
        return recs

    # -- full block ---------------------------------------------------------
    def decode_block_events(self, iq) -> int:
        """One ``[C, B]`` block end to end; events land in
        ``ctxs[c].events``.  Returns the frames accepted (both kinds)."""
        return self.events_from_frontend(self.frontend_sync_device(iq))

    def events_from_frontend(self, fe5) -> int:
        dibits_dev, pat, pos, vq, n_sym = fe5
        ac, at, ak, ascore = self.pick_frames(pat, pos, vq, n_sym)
        self._active = [False] * self.C
        recs = self.decode_records(dibits_dev, ac, at, ak)
        self.last_frames = (ac, at, ak, ascore, recs)
        return sum(self._frame(int(c), int(t), int(k), float(s), rec)
                   for c, t, k, s, rec in zip(ac, at, ak, ascore, recs))

    def _frame(self, c: int, t: int, kind: int, score: float,
               rec: np.ndarray) -> int:
        ctx = self.ctxs[c]
        if kind == 1:
            line, crc_ok, fields = header_line(rec, ctx)
            if not crc_ok and score < self.HD_SOLO_SCORE:
                return 0            # weak hit AND bad CRC: junk
            ctx.emit(f"Sync: +D-STAR HD HEADER  {line}", "dstar", t,
                     **fields)
            return 1
        line = slow_data_line(rec[:60], ctx)
        voice = np.unpackbits(rec[60:249]).reshape(21, 72)
        ambe = np.unpackbits(rec[249:396]).reshape(21, 56)[:, :49]
        errs = rec[396:417].astype(np.int32)
        # any clean frame with speech marks the channel active
        if any(e == 0 and voicing_activity(a) > 0
               for e, a in zip(errs, ambe)):
            self._active[c] = True
        ctx.emit(f"Sync: +D-STAR VOICE  {line}", "dstar", t, voice=voice,
                 ambe49=ambe, ambe_errs=errs)
        return 1

    def channel_state(self, c: int) -> str:
        """'voice' while the last block carried a superframe with active
        voicing, else 'idle'."""
        return "voice" if self._active[c] else "idle"

    def events(self, c: int):
        return self.ctxs[c].events

    def decode_block(self, iq) -> np.ndarray:
        """The voice-group surface: D-STAR has no synthesized PCM, so
        this decodes the block's events and returns ``[C, 0]``."""
        self.decode_block_events(iq)
        return np.zeros((self.C, 0), np.float32)

    def decode_from_frontend(self, fe5) -> np.ndarray:
        self.events_from_frontend(fe5)
        return np.zeros((self.C, 0), np.float32)

    @staticmethod
    def fetch_pcm(handle) -> np.ndarray:
        return handle

    def decode_block_records(self, iq):
        """Parity hook: the block's accepted frames as (channel,
        position, kind, record) without events."""
        dibits_dev, pat, pos, vq, n_sym = self.frontend_sync_device(iq)
        ac, at, ak, _sc = self.pick_frames(pat, pos, vq, n_sym)
        recs = self.decode_records(dibits_dev, ac, at, ak)
        return [(int(c), int(t), int(k), r)
                for c, t, k, r in zip(ac, at, ak, recs)]
