"""Batched many-channel M17 stream pipeline: I/Q → frame numbers, Codec2
payload bits and LICH link data, and Codec2 speech for monitored
channels.

Counterpart of ``dsdneo_tpu/engine/m17batch.py``.  An M17 stream frame is
8 sync + 184 payload dibits (368 bits): derandomized, de-interleaved, a
96-bit LICH (4 × Golay(24,12) → a 40-bit LSF chunk and a 3-bit counter)
and a 272-bit P2-punctured payload (FN16 and 128 voice bits) under the
K=5 convolutional code.  Per block: the gated front end
(``engine.demod.gated_frontend_step``, 4-level) and the ``+M17 STR``
correlation over the clipped soft symbols, the top ``SYNC_TOPK``
positions (a stable descending sort); the host pick (threshold,
192-dibit spacing with ±8 refinement); :func:`m17_stream_decode_device`
on the card — the LICH as a Golay(24,12) codebook product (``argmax``
takes the first maximum, as ``jnp.argmax`` does) and the payload
through the K=5 Viterbi (``fec.device.conv_k5_decode_batch``, kernel K5
on the card) on the depunctured 296 symbols, weight 0 on the punctured
positions; the host gate on the LICH's Golay errors (a junk hit fails
all four words), LSF assembly over the six chunks (CRC 0x5935, the
callsigns, CAN and data type), and Codec2 through the host library for
the ``monitor`` channels whose stream is not encrypted.
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
from dsdneo_tpu_torch.fec.device import _ml_dec, conv_k5_decode_batch
from dsdneo_tpu_torch.protocol.base import DecoderContext
from dsdneo_tpu_torch.protocol.m17.decoder import (_INTERLEAVE, _P2,
                                                   _SCRAMBLE, DT_NAMES,
                                                   ENC_NAMES, _pack_bytes,
                                                   decode_callsign,
                                                   m17_crc16)
from dsdneo_tpu_torch.symbols.framesync import sync_levels
from dsdneo_tpu_torch.vocoder import codec2 as c2

FRAME_DIBITS = 192              # 8 sync + 184 payload
GOLAY_ERR_MAX = 3               # per-block acceptance (host decoder rule)
BLOB = 26


@lru_cache(maxsize=1)
def _m17_tables():
    """(the 368-bit randomizer, the de-interleave gather, the 272 kept
    positions of the 296 P2-punctured coded bits), numpy."""
    keep = np.flatnonzero(np.tile(_P2, 296 // len(_P2) + 1)[:296])
    assert keep.shape[0] == 272
    return (np.asarray(_SCRAMBLE[:368], np.uint8),
            np.asarray(_INTERLEAVE, np.int64), keep.astype(np.int64))


@lru_cache(maxsize=8)
def _consts(device: str) -> dict[str, torch.Tensor]:
    scram, inter, keep = _m17_tables()
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    wt = np.zeros(296, np.float32)
    wt[keep] = 1.0
    return {"scram": on(scram), "inter": on(inter), "keep": on(keep),
            "wt": on(wt), "off": on(8 + np.arange(184)),
            "w": on(np.array([128, 64, 32, 16, 8, 4, 2, 1], np.int32))}


def _pack8(bits: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[..., 8k]`` 0/1 bits → ``[..., k]`` bytes, most significant bit
    first."""
    shp = bits.shape[:-1] + (bits.shape[-1] // 8, 8)
    return (bits.reshape(shp).to(torch.int32) * w).sum(dim=-1).to(
        torch.uint8)


def m17_stream_decode_device(dibits: torch.Tensor, ch: torch.Tensor,
                             pos: torch.Tensor,
                             tables: params.EventTables) -> torch.Tensor:
    """``[F]`` stream frames (``pos`` = sync start; pad channel ``C``) →
    uint8 blob ``[F, 26]``: FN (2) | voice bits packed (16) | the LICH
    chunk and counter packed (6) | the largest Golay error count of the
    four LICH words (1) | the LICH counter (1)."""
    k = _consts(str(dibits.device))
    F = ch.shape[0]
    Tn = dibits.shape[1]
    gp = torch.clamp(pos[:, None] + k["off"], 0, Tn - 1)
    cc = torch.clamp(ch, max=dibits.shape[0] - 1)
    dd = dibits[cc[:, None], gp]                              # [F, 184]
    bits = torch.stack([(dd >> 1) & 1, dd & 1], dim=-1).reshape(F, 368)
    deframe = (bits.to(torch.uint8) ^ k["scram"])[:, k["inter"]]
    msg, gerr = _ml_dec(deframe[:, :96].reshape(-1, 24), tables.golay_pm,
                        tables.golay_cb)
    content = tables.golay_cb[msg][:, :12].reshape(F, 48)     # [F, 48]
    gmax = gerr.reshape(F, 4).amax(dim=-1)
    cnt = (content[:, 40].to(torch.int32) * 4 + content[:, 41] * 2
           + content[:, 42]).to(torch.uint8)
    sym = torch.zeros((F, 296), dtype=torch.float32, device=dd.device)
    sym[:, k["keep"]] = deframe[:, 96:368].to(torch.float32)
    b144 = conv_k5_decode_batch(sym, k["wt"].expand(F, -1))[:, :144]
    return torch.cat([
        _pack8(b144[:, :16], k["w"]),                         # FN
        _pack8(b144[:, 16:144], k["w"]),                      # voice
        _pack8(content, k["w"]),                              # LSF chunk
        torch.clamp(gmax, max=255).to(torch.uint8)[:, None],
        cnt[:, None]], dim=1)


class _M17Chan:
    """Per-channel LSF-chunk assembly and Codec2 state."""

    def __init__(self):
        self.chunks = np.zeros((6, 40), np.uint8)
        self.ok = [False] * 6
        self.dt = 2                 # data type: Voice (3200 bps)
        self.enc = 0
        self.c2 = None


class BatchedM17VoicePipeline:
    """Batched M17 stream decoder over ``[C, B, 2]`` float32 I/Q blocks on
    ``device`` (the card when none is given; raises when there is no
    card).  Events land in ``ctxs[c].events``; Codec2 PCM of the
    ``monitor`` channels (all by default) in ``ctxs[c].audio``, when
    libcodec2 is present."""

    SYNC_NAMES = ("+M17 STR",)
    SYNC_TOPK = 192             # 25 frames/s + shoulders

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, monitor=None, *,
                 device=None, tables: params.EventTables | None = None):
        if device is None:
            device = require_cuda()
        self.tables = (tables if tables is not None
                       else params.load_event("m17", device))
        self.device = self.tables.device
        self.C = C
        self.fs = fs
        self.mode = MODES["m17"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = torch.as_tensor(firdes.channel_lpf(fs,
                                                       self.mode.lpf_profile),
                                    device=self.device)
        self.levels = torch.as_tensor(sync_levels(self.SYNC_NAMES),
                                      device=self.device)
        self.threshold = sync_threshold
        self.monitor = set(range(C)) if monitor is None else set(monitor)
        self.ctxs = [DecoderContext() for _ in range(C)]
        self.chans = [_M17Chan() for _ in range(C)]
        self._active = [False] * C    # per-block stream activity
        self.last_frames = None       # (ch, pos, blob)

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

    def frontend_finish(self, fe):
        """Copy a dispatch's candidates to the host: (dibits_dev, idx
        int64, vq uint8, n_sym)."""
        dibits, idx, vq, n_sym = fe
        return (dibits, idx.cpu().numpy().astype(np.int64), vq.cpu().numpy(),
                n_sym)

    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    def pick_frames(self, idx, vq, n_sym: int):
        """Score threshold and 192-dibit spacing with ±8 local-max
        refinement (a ±1 sync offset garbles the interleave)."""
        acc_c, acc_t = [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            scores = sc[ok][order]
            last = -10 ** 9
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
                    # the refined winner can cross the block end
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t)
        return np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32)

    def decode_frames(self, dibits_dev, ac, at) -> np.ndarray:
        """The device decode of accepted hits, padded to a multiple of 64
        (pad channel ``C``): ``[F, 26]`` blob rows in the hits' order."""
        F = ac.shape[0]
        Fp = -(-F // 64) * 64
        cc = np.full(Fp, self.C, dtype=np.int64)
        tt = np.zeros(Fp, dtype=np.int64)
        cc[:F] = ac
        tt[:F] = at
        return m17_stream_decode_device(
            dibits_dev, torch.as_tensor(cc, device=self.device),
            torch.as_tensor(tt, device=self.device),
            self.tables).cpu().numpy()[:F]

    # -- full block ---------------------------------------------------------
    def decode_block_events(self, iq) -> int:
        """One ``[C, B]`` block end to end; events land in
        ``ctxs[c].events``, synthesized PCM of monitored channels in
        ``ctxs[c].audio``.  Returns the stream frames accepted."""
        return self.events_from_frontend(self.frontend_sync_device(iq))

    def events_from_frontend(self, fe4) -> int:
        dibits_dev, idx, vq, n_sym = fe4
        ac, at = self.pick_frames(idx, vq, n_sym)
        self._active = [False] * self.C
        if ac.shape[0] == 0:
            self.last_frames = (ac, at, np.zeros((0, BLOB), np.uint8))
            return 0
        blob = self.decode_frames(dibits_dev, ac, at)
        self.last_frames = (ac, at, blob)
        n_acc = 0
        for h in range(ac.shape[0]):
            if int(blob[h, 24]) > GOLAY_ERR_MAX:
                continue                      # LICH gate: not a frame
            n_acc += 1
            self._frame(int(ac[h]), int(at[h]), blob[h])
        return n_acc

    def _frame(self, c: int, t: int, rec: np.ndarray) -> None:
        ctx = self.ctxs[c]
        st = self.chans[c]
        fn = (int(rec[0]) << 8) | int(rec[1])
        cnt = int(rec[25])
        line = "Sync: +M17 STR "
        if cnt > 5:
            ctx.emit(line + "LICH CNT ERR", "m17", t)
            return
        line += f"LC: {cnt + 1}/6 FN: {fn & 0x7FFF:04X} "
        if fn & 0x8000:
            line += "EOT "
        st.chunks[cnt] = np.unpackbits(rec[18:23])
        st.ok[cnt] = True
        detail = ""
        if cnt == 5 and all(st.ok):
            lsf = st.chunks.reshape(-1)
            if m17_crc16(_pack_bytes(lsf)) == 0:
                dst = int.from_bytes(np.packbits(lsf[0:48]).tobytes(), "big")
                src = int.from_bytes(np.packbits(lsf[48:96]).tobytes(), "big")
                tw = (int(np.packbits(lsf[96:104])[0]) << 8) \
                    | int(np.packbits(lsf[104:112])[0])
                cn = (tw >> 7) & 0xF
                if tw & 1:
                    st.dt = (tw >> 1) & 3
                    st.enc = (tw >> 3) & 3
                detail = (f"\n CAN: {cn} DST: {decode_callsign(dst)}"
                          f" SRC: {decode_callsign(src)}"
                          f"{DT_NAMES.get(st.dt, '')}"
                          f"{ENC_NAMES.get(st.enc, '') if st.enc else ''}")
                ctx.state.last_src = decode_callsign(src)
            st.ok = [False] * 6
        ctx.emit(line + detail, "m17", t, fn=fn & 0x7FFF, lich_cnt=cnt)
        self._active[c] = True
        if c in self.monitor and st.enc == 0:
            pcm = self._synth(st, rec[2:18])
            if pcm is not None:
                ctx.emit_audio(pcm.astype(np.float32) / 32768.0)

    @staticmethod
    def _synth(st: _M17Chan, voice16: np.ndarray) -> np.ndarray | None:
        """Codec2 speech of one frame's 16 voice bytes (two 3200 bps
        frames, or one 1600 bps frame), or None without libcodec2."""
        if not c2.available():
            return None
        mode = c2.MODE_3200 if st.dt != 3 else c2.MODE_1600
        if st.c2 is None or st.c2.mode != mode:
            st.c2 = c2.Codec2(mode)
        v1 = voice16[:8].tobytes()
        if st.dt == 3:
            return st.c2.decode(v1)
        return np.concatenate([st.c2.decode(v1),
                               st.c2.decode(voice16[8:16].tobytes())])

    def channel_state(self, c: int) -> str:
        """'voice' while the last block carried accepted stream frames,
        else 'idle'."""
        return "voice" if self._active[c] else "idle"

    def decode_block(self, iq) -> np.ndarray:
        """One block → ``[C, n]`` PCM synthesized by this block (monitored
        channels; events keep accumulating in ``ctxs``)."""
        return self.decode_from_frontend(self.frontend_sync_device(iq))

    def decode_from_frontend(self, fe4) -> np.ndarray:
        before = [sum(len(p) for p in ctx.audio.get(0, []))
                  for ctx in self.ctxs]
        self.events_from_frontend(fe4)
        chans = [self.pcm(c)[before[c]:] for c in range(self.C)]
        n = max((ch.size for ch in chans), default=0)
        out = np.zeros((self.C, n), np.float32)
        for c, ch in enumerate(chans):
            out[c, :ch.size] = ch
        return out

    @staticmethod
    def fetch_pcm(handle) -> np.ndarray:
        """``decode_from_frontend`` already returns host PCM."""
        return handle

    def events(self, c: int):
        return self.ctxs[c].events

    def pcm(self, c: int) -> np.ndarray:
        parts = self.ctxs[c].audio.get(0, [])
        if not parts:
            return np.zeros(0, np.float32)
        return np.concatenate(parts)

    def decode_block_records(self, iq):
        """Parity hook: (channels, positions, ``[F, 26]`` blob) of the
        block's picked hits, without events."""
        dibits_dev, idx, vq, n_sym = self.frontend_sync_device(iq)
        ac, at = self.pick_frames(idx, vq, n_sym)
        if ac.size == 0:
            return ac, at, np.zeros((0, BLOB), np.uint8)
        return ac, at, self.decode_frames(dibits_dev, ac, at)
