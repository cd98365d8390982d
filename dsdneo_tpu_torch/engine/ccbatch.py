"""Batched many-channel control-channel monitors: I/Q → trunking events.

Counterpart of ``dsdneo_tpu/engine/ccbatch.py`` for its five monitors.
Everything through the CRC screen runs on the card; the host parses only
the CRC-valid payload blocks through the protocol catalogs and keeps one
``DecoderContext`` per channel, so grants feed trunk following:

P25 Phase 1 TSDU (``BatchedP25ControlPipeline``):
  the voice pipeline's front end, sync filter and NID decode (C4FM
  through kernel K1, or CQPSK) → the host picks DUID-7 hits
  (``pick_frames_by_duid``) → :func:`p25_tsdu_decode_device`: the three
  98-dibit TSBK blocks of every hit, the rate-1/2 trellis Viterbi
  (``fec.device.p25_12_decode_batch``, kernel K4), the CRC16 screen →
  the host parses the passing 12-byte payloads with the TSBK catalog
  (``protocol.p25.phase1``).  A block that fails the screen falls back
  to the host ranked-list decoder (``fec.trellis.p25_12_decode_list``)
  from its raw dibits, carried in the same blob.

DMR Tier III CSBK (``BatchedDmrControlPipeline``):
  front end (K1) + data-sync correlation + the Golay(20,8) slot type at
  every candidate → the host accepts slot-type-3 (CSBK) hits →
  :func:`dmr_csbk_decode_device`: BPTC(196,96) (row Hamming(15,11) and
  column Hamming(13,9) as codebook products) + CRC16 (mask 0xA5A5) → the
  host parses the passing payloads with ``protocol.dmr.csbk``.

NXDN RCCH CAC (``BatchedNxdnControlPipeline``):
  the NXDN voice pipeline's front end (K1) with its per-candidate LICH
  bytes → the host accepts CAC-bearing frames → :func:`nxdn_cac_decode_device`:
  descramble, depermute, depuncture, the K=5 Viterbi
  (``fec.device.conv_k5_decode_batch``, kernel K5), the CRC16-CAC screen
  → the host parses the passing messages with ``protocol.nxdn.decoder``.

EDACS (``BatchedEdacsControlPipeline``):
  the gated front end (2-level, 9600 symbols/s) and the ±EDACS
  correlation → the host pick → :func:`edacs_cc_decode_device`: the
  2-of-3 vote over the three copies of both 40-bit words and the
  dual-polarity BCH(40,28) screen → the host parses the valid message
  pairs with the standard or the EA catalog (``protocol.edacs``).

P25 Phase 2 TDMA xCCH (``BatchedP2ControlPipeline``):
  the Phase 2 voice pipeline's front end (K1) with the DUID and ISCH
  fields of every candidate → the host resolves the superframe position
  and picks the SACCH/FACCH timeslots (``pick_xcch``) →
  :func:`p2_xcch_gather_device` packs them on the card → the host
  descrambles them and screens them with two GF(2) products per kind
  (RS(63,35) parity and CRC12, float32 numpy) → the MAC catalog
  (``protocol.p25.p2_mac``) parses the clean bursts; the others fall
  back to the serial RS(63,35) erasure decode, and scrambled bursts of a
  channel without WACN/SYS/NAC feed the blind recovery of its seed.

The P25, DMR and P25p2 monitors offer a payload-keyed parse cache:
control channels repeat identical blocks many times a second, and a
repeat re-emits the first parse's events.  The products of the codebook
and CRC screens are float32 matrix products of 0/1 and ±1 terms, exact
in full float32 (the card's TF32 switch for matrix products stays off).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.device import require_cuda, to_host
from dsdneo_tpu_torch.dsp import firdes
from dsdneo_tpu_torch.engine.batched import frontend_step
from dsdneo_tpu_torch.engine.demod import gated_frontend_step
from dsdneo_tpu_torch.engine.modes import MODES
from dsdneo_tpu_torch.engine.dmrbatch import _dibits_to_bits
from dsdneo_tpu_torch.engine.nxdnbatch import (FRAME_DIBITS,
                                               BatchedNxdnVoicePipeline,
                                               _lich_parity_ok)
from dsdneo_tpu_torch.engine.p2batch import (SCRAMBLE_BITS, TS_DIBITS,
                                             BatchedP2VoicePipeline)
from dsdneo_tpu_torch.engine.p2batch import FRAME_DIBITS as P2_FRAME_DIBITS
from dsdneo_tpu_torch.engine.voicebatch import (BatchedP25VoicePipeline,
                                                _status_strip_map,
                                                correlate_syncs_device)
from dsdneo_tpu_torch.fec import crc as crcmod
from dsdneo_tpu_torch.fec import trellis
from dsdneo_tpu_torch.fec.device import (_ml_dec, conv_k5_decode_batch,
                                         p25_12_decode_batch)
from dsdneo_tpu_torch.protocol.base import DecoderContext
from dsdneo_tpu_torch.protocol.dmr.csbk import decode_csbk
from dsdneo_tpu_torch.protocol.edacs.decoder import EdacsDecoder, _bch_basis
from dsdneo_tpu_torch.protocol.nxdn.decoder import NxdnDecoder
from dsdneo_tpu_torch.protocol.p25 import p2_xcch
from dsdneo_tpu_torch.protocol.p25.phase1 import P25P1Decoder
from dsdneo_tpu_torch.protocol.p25.phase2 import P25P2Decoder
from dsdneo_tpu_torch.symbols.framesync import (SYNC_DEFS, SyncHit,
                                                sync_levels)

PARSE_CACHE_MAX = 4096      # entries per channel before a cache clears


def _sync_def(name: str):
    return next(d for d in SYNC_DEFS if d.name == name)


def _mask_bits(mask: int, device) -> torch.Tensor:
    return torch.tensor([(mask >> (15 - j)) & 1 for j in range(16)],
                        dtype=torch.uint8, device=device)


# -- the screens ---------------------------------------------------------------
def _crc16_screen(data96: torch.Tensor, xor_mask: int,
                  contrib: torch.Tensor) -> torch.Tensor:
    """``[N, 96]`` payload bits → ``[N]`` bool: crc16(bits[:80], init=0)
    ^ ``xor_mask`` == bits[80:96], as one ``[N, 80] × [80, 16]`` product
    mod 2 (``contrib``: the CRC's contribution row of each bit)."""
    par = torch.remainder(data96[:, :80].to(torch.float32) @ contrib, 2.0)
    par = par.to(torch.uint8) ^ _mask_bits(xor_mask, data96.device)
    return (par == data96[:, 80:96]).all(dim=-1)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[N, 8k]`` 0/1 → ``[N, k]`` bytes, msb first."""
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                     device=bits.device)
    N = bits.shape[0]
    return (bits.reshape(N, -1, 8).to(torch.int32) * w).sum(
        dim=-1).to(torch.uint8)


def _padded(a: np.ndarray, n: int, fill: int, device) -> torch.Tensor:
    out = np.full(n, fill, dtype=np.int64)
    out[:a.shape[0]] = a
    return torch.as_tensor(out, device=device)


# -- P25 Phase 1 TSDU --------------------------------------------------------------
TSDU_BLOCKS = 3              # TSBKs per TSDU
TSDU_BLOB = 12 + 1 + 25      # per block: payload, ok flag, raw dibits


def p25_tsdu_decode_device(dibits: torch.Tensor, ch: torch.Tensor,
                           pos: torch.Tensor, tables: params.CcTables
                           ) -> torch.Tensor:
    """The three TSBK blocks of every accepted hit, trellis-decoded
    (kernel K4 on the card) and CRC16-screened: ``[H]`` (channel, sync
    position) → ``[H, 3·38]`` uint8, per block 12 payload bytes, the ok
    flag and the block's 98 raw dibits packed four to a byte (for the
    host list-decode fallback).  Pad hits use ``ch == C``."""
    Tn = dibits.shape[1]
    H = ch.shape[0]
    gp = torch.clamp(pos[:, None, None] + tables.tsdu_offsets[None], 0,
                     Tn - 1)                                   # [H, 3, 98]
    chc = torch.clamp(ch, max=dibits.shape[0] - 1)
    dd = dibits[chc[:, None, None], gp].reshape(-1, 98)        # [3H, 98]
    data96, _cost = p25_12_decode_batch(_dibits_to_bits(dd))
    ok = _crc16_screen(data96, 0xFFFF, tables.crc16_contrib)
    ddp = torch.nn.functional.pad(dd, (0, 2))                  # 98 → 100
    raw = ((ddp[:, 0::4] << 6) | (ddp[:, 1::4] << 4)
           | (ddp[:, 2::4] << 2) | ddp[:, 3::4]).to(torch.uint8)
    blk = torch.cat([_pack_bits(data96), ok[:, None].to(torch.uint8), raw],
                    dim=1)                                     # [3H, 38]
    return blk.reshape(H, -1)


class BatchedP25ControlPipeline(BatchedP25VoicePipeline):
    """Batched P25p1 trunking control monitor over ``[C, B, 2]`` float32
    I/Q blocks on ``device`` (the card when none is given; raises when
    there is no card).  The front end, sync filter and NID decode are the
    voice pipeline's; it picks TSDU (DUID 7) hits and runs the TSBK path.
    Events land in ``ctxs[c].events``."""

    NID_TOPK = 128      # control channels carry ~13 TSDUs/s and shoulders

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, parse_cache: bool = True,
                 cqpsk: bool = False, *, device=None,
                 tables: params.CcTables | None = None):
        if device is None:
            device = require_cuda()
        self.cc = tables if tables is not None else params.load_cc(
            "p25", device)
        super().__init__(C, fs=fs, sync_threshold=sync_threshold,
                         cqpsk=cqpsk, device=device, tables=self.cc.front)
        self.ctxs = [DecoderContext() for _ in range(C)]
        self.decs = [P25P1Decoder() for _ in range(C)]
        self.parse_cache = parse_cache
        self._pcache: list[dict] = [dict() for _ in range(C)]
        self._hit_def = _sync_def(self.SYNC_NAMES[0])
        strip = _status_strip_map(self.tables.sync_len, 32 + 98)
        self._tsdu_need = int(strip[-1]) + 1
        self.crc_fallbacks = 0
        self.crc_errors = 0
        self.last_tsdus = None

    def pick_tsdus(self, idx, vq, dq, msg, T: int, dibits_dev=None):
        """Accepted TSDU hits (channel, sync position, NID message).  The
        acceptance extent is the shortest TSDU, one trellis block: a
        single-TSBK TSDU flagged Last Block is ~106 dibits, so LSM
        control channels send TSDUs 180 dibits apart, and the full
        three-block extent would drop every other one.  False syncs
        inside a longer TSDU fail the BCH-validated DUID gate."""
        ac, at, am, _fch, _ford = self.pick_frames_by_duid(
            idx, vq, dq, msg, T, (7,), self._tsdu_need, 1, dibits_dev)
        return ac, at, am

    def _parse_tsbk(self, c: int, pos: int, payload12: np.ndarray) -> bool:
        """Host catalog parse of one CRC-valid TSBK payload; returns the
        Last Block flag.  With the parse cache, a repeat of a payload
        re-emits the first parse's events."""
        ctx = self.ctxs[c]
        # the iden table's version joins the key: the frequency notes
        # change once an IDEN_UP fills the channel → frequency math
        iden_v = getattr(getattr(ctx.state, "iden_table", None),
                         "version", 0)
        key = (payload12.tobytes(), iden_v)
        if self.parse_cache:
            hitv = self._pcache[c].get(key)
            if hitv is not None:
                lb, events = hitv
                for line, fields in events:
                    ctx.emit(line, "p25p1", pos, **fields)
                return lb
        hit = SyncHit(pos=pos, score=1.0, sync=self._hit_def)
        n0 = len(ctx.events)
        lb = self.decs[c]._tsbk(np.unpackbits(payload12), hit, ctx)
        if self.parse_cache:
            pc = self._pcache[c]
            if len(pc) >= PARSE_CACHE_MAX:
                # varying payloads (time broadcasts, grants) and iden
                # version bumps would accrete dead entries forever; a
                # clear refills from live traffic in a few blocks
                pc.clear()
            pc[key] = (lb, [(e.line, dict(e.fields))
                            for e in ctx.events[n0:]])
        return lb

    def decode_block_events(self, iq) -> int:
        """One ``[C, B]`` block end to end; returns the number of
        CRC-valid TSBKs parsed."""
        return self.events_from_frontend(
            self.frontend_finish(self.frontend_dispatch(iq)))

    def events_from_frontend(self, fe6, cofetch=None):
        """Pick, device TSBK decode and host catalog parse from a finished
        front end.  ``cofetch``: a tensor (e.g. a voice pipeline's PCM
        wire), or a tuple of them, copied to the host with the TSDU blob;
        then returns ``(n_parsed, cofetch as numpy)``, a tuple for a
        tuple, as ``jax.device_get`` returns it."""
        dibits_dev, idx, vq, dq, msg, n_sym = fe6
        ac, at, am = self.pick_tsdus(idx, vq, dq, msg, n_sym,
                                     dibits_dev=dibits_dev)
        H = ac.shape[0]
        co_np = to_host(cofetch)
        if H == 0:
            self.last_tsdus = None
            return 0 if cofetch is None else (0, co_np)
        Hp = -(-H // 64) * 64
        dev = self.device
        blob = p25_tsdu_decode_device(
            dibits_dev, _padded(ac, Hp, self.C, dev), _padded(at, Hp, 0, dev),
            self.cc).cpu().numpy()
        blk = blob[:H].reshape(H, TSDU_BLOCKS, TSDU_BLOB)
        self.last_tsdus = (ac, at, blk)
        payloads = blk[:, :, :12]
        oks = blk[:, :, 12] != 0
        raws = blk[:, :, 13:]
        n_parsed = 0
        for h in range(H):
            c, t = int(ac[h]), int(at[h])
            ctx = self.ctxs[c]
            nac = (int(am[h]) >> 4) & 0xFFF
            if nac not in (0, 0xFFF):
                ctx.state.nac = nac
                ctx.state.p2_cc = nac
            ctx.emit(f"Sync: +P25p1 | {ctx.frame_info()}TSDU",
                     "p25p1", t, nac=nac, duid=7)
            for b in range(TSDU_BLOCKS):
                if oks[h, b]:
                    data = payloads[h, b]
                else:
                    data = self._crc_fallback(raws[h, b])
                    if data is None:
                        self.crc_errors += 1
                        ctx.emit(" TSBK CRC ERR", "p25p1", t)
                        break
                    self.crc_fallbacks += 1
                n_parsed += 1
                if self._parse_tsbk(c, t, data):
                    break
        return n_parsed if cofetch is None else (n_parsed, co_np)

    @staticmethod
    def _crc_fallback(raw25: np.ndarray) -> np.ndarray | None:
        """Host ranked-list trellis decode of one CRC-failed block from
        its packed raw dibits: the first candidate that passes the CRC,
        packed, else None."""
        dd = np.zeros(100, dtype=np.uint8)
        dd[0::4] = (raw25 >> 6) & 3
        dd[1::4] = (raw25 >> 4) & 3
        dd[2::4] = (raw25 >> 2) & 3
        dd[3::4] = raw25 & 3
        bits = np.zeros(196, dtype=np.uint8)
        bits[0::2] = (dd[:98] >> 1) & 1
        bits[1::2] = dd[:98] & 1
        for data96, _m in trellis.p25_12_decode_list(bits):
            got = crcmod.crc16_bits(data96[:80], init=0, xorout=0xFFFF)
            want = 0
            for v in data96[80:96]:
                want = (want << 1) | int(v)
            if got == want:
                return np.packbits(data96)
        return None

    def events(self, c: int):
        return self.ctxs[c].events


# -- DMR Tier III CSBK ---------------------------------------------------------------
DMR_BURST_EXTENT = 78        # dibits past the sync start of a data burst


def bptc_196_96_decode_batch(bits196: torch.Tensor,
                             tables: params.CcTables):
    """Batched BPTC(196,96): ``[N, 196]`` on-air bits → (``[N, 96]``
    uint8 payload, ``[N]`` int32 error count).  The row Hamming(15,11)
    ML decode corrects the data columns of rows 0-8, then the column
    Hamming(13,9) ML decode over the partly corrected matrix corrects
    rows 0-8 of every column; the count is of codewords that needed more
    than a one-bit correction."""
    N = bits196.shape[0]
    mat = bits196[:, tables.bptc_gather].reshape(N, 13, 15).clone()
    rows = mat[:, :9].reshape(N * 9, 15)
    m, rerr = _ml_dec(rows, tables.h15_pm, tables.h15_cb)
    mat[:, :9, :11] = tables.h15_cb[m][:, :11].reshape(N, 9, 11)
    cols = mat.transpose(1, 2).reshape(N * 15, 13)
    m, cerr = _ml_dec(cols, tables.h13_pm, tables.h13_cb)
    mat[:, :9, :] = tables.h13_cb[m][:, :9].reshape(N, 15, 9).transpose(1, 2)
    payload = torch.cat([mat[:, 0, 3:11], mat[:, 1:9, :11].reshape(N, 88)],
                        dim=1)
    errors = ((rerr.reshape(N, 9) > 1).sum(dim=-1)
              + (cerr.reshape(N, 15) > 1).sum(dim=-1)).to(torch.int32)
    return payload.to(torch.uint8), errors


def dmr_csbk_decode_device(dibits: torch.Tensor, ch: torch.Tensor,
                           pos: torch.Tensor, inv: torch.Tensor,
                           tables: params.CcTables) -> torch.Tensor:
    """Each accepted data burst's 196 payload bits (``inv`` flags the
    inverted-data hypothesis, dibit ^ 2), BPTC decode and the CRC16
    (mask 0xA5A5) screen: ``[H, 14]`` uint8, 12 payload bytes, the ok
    flag and the BPTC error count."""
    Tn = dibits.shape[1]
    gp = torch.clamp(pos[:, None] + tables.dmr_payload_offs, 0, Tn - 1)
    chc = torch.clamp(ch, max=dibits.shape[0] - 1)
    dd = dibits[chc[:, None], gp]                              # [H, 98]
    dd = dd ^ (inv[:, None] * 2).to(dd.dtype)
    payload, errors = bptc_196_96_decode_batch(_dibits_to_bits(dd), tables)
    ok = _crc16_screen(payload, 0xFFFF ^ 0xA5A5, tables.crc16_contrib)
    return torch.cat([_pack_bits(payload), ok[:, None].to(torch.uint8),
                      torch.clamp(errors, 0, 255)[:, None].to(torch.uint8)],
                     dim=1)


class BatchedDmrControlPipeline:
    """Batched DMR Tier III CSBK monitor over ``[C, B, 2]`` float32 I/Q
    blocks on ``device`` (the card when none is given; raises when there
    is no card): data-sync correlation and the Golay(20,8) slot type of
    every candidate in the front end, the BPTC + CRC screen on the card,
    the CSBK catalog on the host."""

    # DMR data and voice syncs are exact symbol complements, so a
    # voice-pattern hit on an inverted channel is a data burst: pattern 0
    # is upright data, pattern 1 (the voice pattern) the inverted-data
    # hypothesis, settled by the slot type's Golay confidence gate
    SYNC_NAMES = ("+DMR BS data", "+DMR BS voice")
    SYNC_TOPK = 192          # ~16.7 data bursts/s per slot and shoulders

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, parse_cache: bool = True, *,
                 device=None, tables: params.CcTables | None = None):
        if device is None:
            device = require_cuda()
        self.cc = tables if tables is not None else params.load_cc(
            "dmr", device)
        self.device = torch.empty(0, device=device).device
        if self.cc.front.taps.device != self.device:
            raise ValueError("tables live on another device than the "
                             "pipeline")
        self.C = C
        self.fs = fs
        self.sps = fs / self.cc.front.symbol_rate
        self.threshold = sync_threshold
        self.ctxs = [DecoderContext() for _ in range(C)]
        self.parse_cache = parse_cache
        self._pcache: list[dict] = [dict() for _ in range(C)]
        self._hit_def = _sync_def(self.SYNC_NAMES[0])
        self.crc_errors = 0
        self.last_csbks = None

    def frontend_dispatch(self, iq):
        """Queue the front end, data-sync correlation and slot-type decode
        of one block: returns the device handle (dibits, idx, vq, dq,
        slot-type message, slot-type bit errors, n_sym)."""
        x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
        n_sym = int(x.shape[1] // self.sps) - 2
        f, cc = self.cc.front, self.cc
        dibits, soft, _power = frontend_step(x, f.taps, self.sps, n_sym,
                                             f.four_level)
        sc = correlate_syncs_device(soft, cc.sync_levels)      # [C, 2, T']
        best_def = torch.argmax(sc, dim=1).to(torch.uint8)
        bs = torch.amax(sc, dim=1)
        k_cand = min(self.SYNC_TOPK, n_sym - cc.sync_levels.shape[1] + 1)
        vals, idx = torch.sort(bs, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k_cand], idx[:, :k_cand]
        vq = torch.clamp(vals * 127.0, 0, 255).to(torch.uint8)
        dq = torch.gather(best_def, 1, idx)
        # the slot type at every candidate; pattern 1 flips the dibits
        Cn, Tn = dibits.shape
        gp = torch.clamp(idx[:, :, None] + cc.dmr_st_offs, 0, Tn - 1)
        dd = dibits[torch.arange(Cn, device=self.device)[:, None, None], gp]
        dd = dd ^ ((dq & 1) * 2)[:, :, None]
        b20 = _dibits_to_bits(dd)                              # [C, K, 20]
        s = 1.0 - 2.0 * b20.to(torch.float32)
        m = torch.argmax(s @ cc.golay20_pm.T, dim=-1)
        errs = (cc.golay20_cb[m] != b20).sum(dim=-1)
        return (dibits, idx, vq, dq, m.to(torch.uint8),
                torch.clamp(errs, 0, 255).to(torch.uint8), n_sym)

    def frontend_finish(self, fe):
        """Copy a dispatch's candidates to the host: (dibits_dev, idx
        int64, vq, dq, st, se uint8, n_sym)."""
        dibits, idx, vq, dq, st, se, n_sym = fe
        return (dibits, idx.cpu().numpy().astype(np.int64),
                vq.cpu().numpy(), dq.cpu().numpy(), st.cpu().numpy(),
                se.cpu().numpy(), n_sym)

    def frontend_sync_device(self, iq):
        return self.frontend_finish(self.frontend_dispatch(iq))

    def pick_csbks(self, idx, vq, dq, st, se, n_sym: int):
        """Data-sync hits → accepted (channel, position, inverted, color
        code) of slot-type-3 (CSBK) bursts: the score threshold, at most
        2 slot-type bit errors, 24 dibits past the last accepted hit.
        Pattern 1 hits are the inverted-data hypothesis."""
        acc_c, acc_t, acc_i, acc_cc = [], [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = (sc >= self.threshold) & (se[c] <= 2)
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            pdefs = dq[c][ok][order]
            types = st[c][ok][order]
            last = -10 ** 9
            for t, dfi, m in zip(positions, pdefs, types):
                t = int(t)
                if t - last < 24 or t < 54 or t + DMR_BURST_EXTENT >= n_sym:
                    continue
                last = t
                if int(m) & 0xF != 3:       # CSBK only
                    continue
                acc_c.append(c)
                acc_t.append(t)
                acc_i.append(int(dfi) & 1)
                acc_cc.append((int(m) >> 4) & 0xF)
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_i, np.int32), np.asarray(acc_cc, np.int32))

    def _parse_csbk(self, c: int, pos: int, cc: int,
                    payload12: np.ndarray) -> None:
        ctx = self.ctxs[c]
        key = payload12.tobytes()
        if self.parse_cache:
            hitv = self._pcache[c].get(key)
            if hitv is not None:
                for line, fields in hitv:
                    ctx.emit(line, "dmr", pos, **fields)
                return
        hit = SyncHit(pos=pos, score=1.0, sync=self._hit_def)
        n0 = len(ctx.events)
        detail = decode_csbk(np.unpackbits(payload12), ctx, hit=hit, slot=0)
        ctx.emit(f"Sync: +DMR CC | Color Code={cc:02d} | CSBK{detail}",
                 "dmr", pos, cc=cc)
        if self.parse_cache:
            pc = self._pcache[c]
            if len(pc) >= PARSE_CACHE_MAX:
                pc.clear()
            pc[key] = [(e.line, dict(e.fields)) for e in ctx.events[n0:]]

    def decode_block_events(self, iq) -> int:
        """One ``[C, B]`` block → CSBK events in ``ctxs``; returns the
        number of CRC-valid CSBKs parsed."""
        return self.events_from_frontend(self.frontend_sync_device(iq))

    def events_from_frontend(self, fe7) -> int:
        dibits_dev, idx, vq, dq, st, se, n_sym = fe7
        ac, at, ai, acc = self.pick_csbks(idx, vq, dq, st, se, n_sym)
        H = ac.shape[0]
        if H == 0:
            self.last_csbks = None
            return 0
        Hp = -(-H // 64) * 64
        dev = self.device
        blob = dmr_csbk_decode_device(
            dibits_dev, _padded(ac, Hp, self.C, dev), _padded(at, Hp, 0, dev),
            _padded(ai, Hp, 0, dev), self.cc).cpu().numpy()[:H]
        self.last_csbks = (ac, at, blob)
        n_parsed = 0
        for h in range(H):
            c, t = int(ac[h]), int(at[h])
            head = f"Sync: +DMR CC | Color Code={int(acc[h]):02d} | CSBK"
            if blob[h, 13] > 0 and not blob[h, 12]:
                # an unrecovered BPTC burst: the serial path emits the
                # burst head with no detail
                self.ctxs[c].emit(head, "dmr", t)
            elif blob[h, 12]:
                self._parse_csbk(c, t, int(acc[h]), blob[h, :12])
                n_parsed += 1
            else:
                self.crc_errors += 1
                self.ctxs[c].emit(head + " CRC ERR", "dmr", t)
        return n_parsed

    def events(self, c: int):
        return self.ctxs[c].events


# -- NXDN RCCH CAC -------------------------------------------------------------------
CAC_BLOB = 22 + 1            # 171 bits and 5 pad packed, the ok flag


def nxdn_cac_decode_device(dibits: torch.Tensor, ch: torch.Tensor,
                           pos: torch.Tensor, tables: params.CcTables
                           ) -> torch.Tensor:
    """The 150 CAC dibits of every accepted RCCH frame, descrambled,
    depermuted and depunctured into 350 weighted symbols, the K=5 Viterbi
    (kernel K5 on the card) and the CRC16-CAC screen: ``[H, 23]`` uint8,
    22 packed payload bytes (171 bits and 5 zero bits) and the ok
    flag."""
    Tn = dibits.shape[1]
    gp = torch.clamp(pos[:, None] + tables.cac_offs, 0, Tn - 1)
    chc = torch.clamp(ch, max=dibits.shape[0] - 1)
    dd = dibits[chc[:, None], gp] ^ (tables.cac_flips * 2)     # [H, 150]
    bits300 = _dibits_to_bits(dd)
    sym = bits300[:, tables.cac_src_idx].to(torch.float32)     # [H, 350]
    wts = tables.cac_wt.expand(sym.shape[0], -1)
    dec = conv_k5_decode_batch(sym, wts)[:, :171]
    par = torch.remainder(dec.to(torch.float32) @ tables.cac_crc_tab, 2.0)
    ok = (par.to(torch.int32) == tables.cac_a_bits).all(dim=-1)
    pad = torch.zeros((dec.shape[0], 5), dtype=torch.uint8, device=dec.device)
    pb = _pack_bits(torch.cat([dec, pad], dim=1))
    return torch.cat([pb, ok[:, None].to(torch.uint8)], dim=1)


class BatchedNxdnControlPipeline:
    """Batched NXDN RCCH monitor over ``[C, B, 2]`` float32 I/Q blocks on
    ``device`` (the card when none is given; raises when there is no
    card): the NXDN voice pipeline's front end gives each candidate's
    LICH byte; CAC frames decode on the card through the K=5 Viterbi and
    the CRC16-CAC screen; the host parses the valid messages."""

    _CAC_LICH = {0x01, 0x05}        # CAC-bearing LICH values

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.55, mode: str = "nxdn48", *,
                 device=None, tables: params.CcTables | None = None):
        if device is None:
            device = require_cuda()
        self.cc = tables if tables is not None else params.load_cc(
            mode, device)
        self._fe = BatchedNxdnVoicePipeline(
            C, fs=fs, sync_threshold=sync_threshold, mode=mode,
            device=device, tables=self.cc.front)
        self.device = self._fe.device
        self.C = C
        self.threshold = sync_threshold
        self.ctxs = [DecoderContext() for _ in range(C)]
        for ctx in self.ctxs:
            ctx.mode_name = mode
        self.decs = [NxdnDecoder() for _ in range(C)]
        self.crc_errors = 0
        self.last_cacs = None

    def pick_cacs(self, idx, vq, dq, lich, n_sym: int):
        """Threshold, shoulder suppression and the LICH parity and
        profile gate → accepted (channel, FSW position, LICH) lists."""
        acc_c, acc_t, acc_l = [], [], []
        for c in range(idx.shape[0]):
            sc = vq[c].astype(np.float32) / 127.0
            ok = sc >= self.threshold
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            scores = sc[ok][order]
            lichs = lich[c][ok][order]
            last = -10 ** 9
            j = 0
            while j < len(positions):
                t = int(positions[j])
                # refine to the best score within 8 positions
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                lf = int(lichs[w])
                j = k
                # the stride counts from accepted frames only: a random
                # candidate with a parity-valid LICH by chance must not
                # suppress a true frame behind it
                if t - last < FRAME_DIBITS - 8 \
                        or t + FRAME_DIBITS >= n_sym:
                    continue
                if not _lich_parity_ok(lf):
                    continue
                if (lf >> 1) in self._CAC_LICH:
                    last = t
                    acc_c.append(c)
                    acc_t.append(t)
                    acc_l.append(lf >> 1)
        return (np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32),
                np.asarray(acc_l, np.int32))

    def frontend_dispatch(self, iq):
        return self._fe.frontend_dispatch(iq)

    def frontend_finish(self, fe):
        return self._fe.frontend_finish(fe)

    def decode_block_events(self, iq) -> int:
        """One ``[C, B]`` block → RCCH events in ``ctxs``; returns the
        number of CRC-valid CACs parsed."""
        return self.events_from_frontend(self._fe.frontend_sync_device(iq))

    def events_from_frontend(self, fe6) -> int:
        dibits_dev, idx, vq, dq, lich, n_sym = fe6
        ac, at, _al = self.pick_cacs(idx, vq, dq, lich, n_sym)
        H = ac.shape[0]
        if H == 0:
            self.last_cacs = None
            return 0
        Hp = -(-H // 32) * 32
        dev = self.device
        blob = nxdn_cac_decode_device(
            dibits_dev, _padded(ac, Hp, self.C, dev), _padded(at, Hp, 0, dev),
            self.cc).cpu().numpy()[:H]
        self.last_cacs = (ac, at, blob)
        n = 0
        for h in range(H):
            c, t = int(ac[h]), int(at[h])
            ctx = self.ctxs[c]
            if not blob[h, 22]:
                self.crc_errors += 1
                ctx.emit(" CAC CRC ERR", "nxdn", t)
                continue
            dec = np.unpackbits(blob[h, :22])[:171]
            ran = 0
            for b in dec[2:8]:
                ran = (ran << 1) | int(b)
            ctx.state.nxdn_ran = ran
            detail = self.decs[c]._message(dec[8:155], ctx)
            ctx.emit(f"Sync: NXDN CC  RCCH CAC RAN {ran:02d}{detail}",
                     "nxdn", t, ran=ran)
            n += 1
        return n

    def events(self, c: int):
        return self.ctxs[c].events


# -- EDACS control channel --------------------------------------------------------
EDACS_BLOB = 12             # msg1 4 bytes + msg2 4 bytes + ok + inv + 2 pad


@lru_cache(maxsize=8)
def _edacs_consts(device: str) -> dict[str, torch.Tensor]:
    """The BCH(40,28) parity rows as float32 and the weights that pack a
    28-bit message, on ``device``."""
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {"basis": on(_bch_basis().astype(np.float32)),
            "w28": on(np.array([1 << (27 - i) for i in range(28)],
                               np.int64)),
            "off": on(np.arange(240, dtype=np.int64))}


def edacs_cc_decode_device(dibits: torch.Tensor, ch: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """The 240 message dibits of every accepted frame (``pos`` = message
    start; pad channel ``C``; 2-level, so the sign bit is the data bit),
    the bitwise 2-of-3 vote over the three copies of each 40-bit word,
    and the BCH(40,28) parity screen for both polarities (an inverted
    channel complements every word) as a mod-2 product of 0/1 terms,
    exact in float32: ``[H, 12]`` uint8, msg1 and msg2 (the 28-bit
    messages after the polarity) as little-endian uint32, the ok flag,
    the inverted flag and two zero bytes."""
    k = _edacs_consts(str(dibits.device))
    Tn = dibits.shape[1]
    gp = torch.clamp(pos[:, None] + k["off"], 0, Tn - 1)
    chc = torch.clamp(ch, max=dibits.shape[0] - 1)
    bits = ((dibits[chc[:, None], gp] >> 1) & 1).to(torch.int32)
    fr = bits.reshape(-1, 6, 40)
    m1 = (fr[:, 0] + fr[:, 1] + fr[:, 2] >= 2).to(torch.int32)  # [H, 40]
    m2 = (fr[:, 3] + fr[:, 4] + fr[:, 5] >= 2).to(torch.int32)

    def bch_ok(w):                              # [H, 40] → [H] bool
        par = torch.remainder(w[:, :28].to(torch.float32) @ k["basis"], 2.0)
        return (par.to(torch.int32) == w[:, 28:40]).all(dim=-1)

    ok_n = bch_ok(m1) & bch_ok(m2)
    ok_c = bch_ok(1 - m1) & bch_ok(1 - m2)
    inv = ~ok_n & ok_c
    ok = ok_n | ok_c
    m1f = torch.where(inv[:, None], 1 - m1, m1)
    m2f = torch.where(inv[:, None], 1 - m2, m2)
    v1 = (m1f[:, :28].to(torch.int64) * k["w28"]).sum(dim=1)
    v2 = (m2f[:, :28].to(torch.int64) * k["w28"]).sum(dim=1)
    shifts = torch.arange(0, 32, 8, device=dibits.device)
    le = lambda v: ((v[:, None] >> shifts) & 0xFF).to(torch.uint8)  # noqa
    return torch.cat([le(v1), le(v2), ok[:, None].to(torch.uint8),
                      inv[:, None].to(torch.uint8),
                      torch.zeros((v1.shape[0], 2), dtype=torch.uint8,
                                  device=dibits.device)], dim=1)


class BatchedEdacsControlPipeline:
    """Batched EDACS trunking control monitor over ``[C, B, 2]`` float32
    I/Q blocks on ``device`` (the card when none is given; raises when
    there is no card; it needs no tables): the gated front end (2-level) and the ±EDACS
    correlation on the card, the host pick, the 2-of-3 vote and the
    dual-polarity BCH(40,28) screen on the card
    (:func:`edacs_cc_decode_device`), and the host parse of the valid
    message pairs through the standard or the EA catalog
    (``protocol.edacs.decoder``), after the ESK mask.  ``ea_mode`` and
    ``esk_mask`` set every channel's context (``state.edacs_ea``,
    ``state.edacs_esk``), which the parse reads per channel."""

    SYNC_NAMES = ("+EDACS", "-EDACS")
    # the JAX package keeps 96 ("~33 frames/s + shoulders",
    # dsdneo_tpu/engine/ccbatch.py:436), but a continuous control channel
    # sends 33.3 frames a second, ~100 in a 3 s block, so 96 drops frames
    # there (ROADMAP queue 3); 128 holds every frame of a 3 s block
    SYNC_TOPK = 128
    FRAME_EXTENT = 48 + 240

    def __init__(self, C: int, fs: float = 48000.0,
                 sync_threshold: float = 0.62, ea_mode: bool = False,
                 esk_mask: int = 0, *, device=None):
        if device is None:
            device = require_cuda()
        self.device = torch.empty(0, device=device).device
        self.C = C
        self.fs = fs
        self.mode = MODES["edacs"]
        self.sps = fs / self.mode.symbol_rate
        self.taps = torch.as_tensor(firdes.channel_lpf(fs,
                                                       self.mode.lpf_profile),
                                    device=self.device)
        self.levels = torch.as_tensor(sync_levels(self.SYNC_NAMES),
                                      device=self.device)
        self.n_pat = int(self.levels.shape[1])
        self.threshold = sync_threshold
        self.ctxs = [DecoderContext() for _ in range(C)]
        for ctx in self.ctxs:
            ctx.state.edacs_ea = ea_mode
            ctx.state.edacs_esk = esk_mask
        self.decs = [EdacsDecoder() for _ in range(C)]
        self.bch_errors = 0
        self.last_frames = None

    def frontend_dispatch(self, iq):
        """Queue the gated front end and the sync filter of one block:
        returns the device handle (dibits, idx, vq, n_sym)."""
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
        """Threshold, the best score of an 8-position shoulder and the
        288-dibit frame spacing → accepted (channel, message start)."""
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
                w = j
                k = j + 1
                while k < len(positions) and positions[k] < t + 8:
                    if scores[k] > scores[w]:
                        w = k
                    k += 1
                t = int(positions[w])
                j = k
                if t - last < self.FRAME_EXTENT - 8 \
                        or t + self.n_pat + 240 >= n_sym:
                    continue
                last = t
                acc_c.append(c)
                acc_t.append(t + self.n_pat)        # message start
        return np.asarray(acc_c, np.int32), np.asarray(acc_t, np.int32)

    def decode_frames(self, dibits_dev, ac, at) -> np.ndarray:
        """The device decode of accepted frames, padded to a multiple of
        32 (pad channel ``C``): ``[H, 12]`` blob rows in their order."""
        H = ac.shape[0]
        Hp = -(-H // 32) * 32
        dev = self.device
        return edacs_cc_decode_device(
            dibits_dev, _padded(ac, Hp, self.C, dev),
            _padded(at, Hp, 0, dev)).cpu().numpy()[:H]

    def decode_block_events(self, iq) -> int:
        """One ``[C, B]`` block → EDACS events in ``ctxs``; returns the
        number of BCH-valid frames parsed."""
        return self.events_from_frontend(self.frontend_sync_device(iq))

    def events_from_frontend(self, fe4) -> int:
        dibits_dev, idx, vq, n_sym = fe4
        ac, at = self.pick_frames(idx, vq, n_sym)
        if ac.shape[0] == 0:
            self.last_frames = (ac, at, np.zeros((0, EDACS_BLOB), np.uint8))
            return 0
        blob = self.decode_frames(dibits_dev, ac, at)
        self.last_frames = (ac, at, blob)
        sync = _sync_def("+EDACS")
        n = 0
        for h in range(ac.shape[0]):
            c, t = int(ac[h]), int(at[h])
            ctx = self.ctxs[c]
            if not blob[h, 8]:
                self.bch_errors += 1
                ctx.emit("Sync: +EDACS  BCH FAIL", "edacs", t)
                continue
            v1 = int(blob[h, 0:4].copy().view("<u4")[0])
            v2 = int(blob[h, 4:8].copy().view("<u4")[0])
            esk = int(getattr(ctx.state, "edacs_esk", 0) or 0)
            if esk:
                v1 ^= (esk & 0xFF) << 20
                v2 ^= (esk & 0xFF) << 20
            dec = self.decs[c]
            hit = SyncHit(pos=t, score=1.0, sync=sync)
            if getattr(ctx.state, "edacs_ea", False):
                line = dec._extended(v1, v2, ctx, hit)
            else:
                line = dec._standard(v1, v2, ctx, hit)
            pol = "-" if blob[h, 9] else "+"
            ctx.emit(f"Sync: {pol}EDACS {line}", "edacs", t,
                     mt=v1 >> 23, word=v1)
            n += 1
        return n

    def events(self, c: int):
        return self.ctxs[c].events


# -- P25 Phase 2 TDMA control channel ------------------------------------------------
def p2_xcch_gather_device(dibits: torch.Tensor, ch: torch.Tensor,
                          tpos: torch.Tensor) -> torch.Tensor:
    """The 180 dibits of every accepted xCCH timeslot, packed to
    ``[N, 45]`` bytes (360 bits msb first; reference p25p2_frame.c
    timeslot geometry; the 4th timeslot of a frame is only 320 bits,
    and its tail gathers the next sync, which the payload and parity
    never read).  Packed on the device: at fleet scale the burst blob is
    the monitor's largest copy to the host.  Pad bursts use
    ``ch == C``."""
    Tn = dibits.shape[1]
    gp = torch.clamp(tpos[:, None]
                     + torch.arange(TS_DIBITS, device=dibits.device),
                     0, Tn - 1)
    chc = torch.clamp(ch, max=dibits.shape[0] - 1)
    return _pack_bits(_dibits_to_bits(dibits[chc[:, None], gp]))


@lru_cache(maxsize=1)
def _xcch_index_arrays() -> dict:
    """(payload, parity) bit positions of each xCCH kind: the vectorized
    form of ``p2_xcch.extract_sacch`` / ``extract_facch``."""
    sp = np.r_[2:74, 76:184].astype(np.int64)
    sq = np.r_[184:244, 246:318].astype(np.int64)
    fp = np.r_[2:74, 76:138, 180:202].astype(np.int64)
    fq = np.r_[202:244, 246:318].astype(np.int64)
    return {"sacch": (sp, sq), "facch": (fp, fq)}


class BatchedP2ControlPipeline(BatchedP2VoicePipeline):
    """Batched P25 Phase 2 TDMA control-channel monitor over ``[C, B, 2]``
    float32 I/Q blocks on ``device`` (the card when none is given; raises
    when there is no card); reference ``state->p25_cc_is_tdma``, a TDMA
    LCCH control channel at 6000 symbols/s
    (src/protocol/p25/p25_trunk_sm.c:289 and phase2/p25p2_vpdu.c
    MAC_SIGNAL handling).

    The front end (kernel K1), the sync filter and the DUID and ISCH
    gathers are the voice pipeline's; instead of voice timeslots it
    accepts the xCCH bursts (SACCH/FACCH/LCCH), gathers and packs them
    on the device (:func:`p2_xcch_gather_device`), and screens them on
    the host with two GF(2) products per burst kind (the systematic
    RS(63,35) encode map and the CRC12 contribution table), so only
    clean bursts go to the MAC parse and channel-errored bursts fall
    back to the serial Berlekamp-Massey erasure decode.  With
    ``wacn=sysid=nac=0`` each channel's scramble parameters are
    recovered blind from RS parity linearity
    (``P25P2Decoder._try_recover_params``).  Events land in
    ``ctxs[c].events``."""

    # duid → (kind, scrambled, lcch); reference p25p2_frame.c typing
    XCCH_DUIDS = {3: ("sacch", True, False), 12: ("sacch", False, False),
                  4: ("sacch", True, True), 13: ("sacch", False, True),
                  9: ("facch", True, False), 15: ("facch", False, False)}

    def __init__(self, C: int, fs: float = 48000.0, wacn: int = 0,
                 sysid: int = 0, nac: int = 0,
                 sync_threshold: float = 0.62, parse_cache: bool = True,
                 *, device=None, tables: params.TdmaTables | None = None):
        super().__init__(C, fs=fs, wacn=wacn, sysid=sysid, nac=nac,
                         sync_threshold=sync_threshold, device=device,
                         tables=tables)
        self.ctxs = [DecoderContext() for _ in range(C)]
        self.decs = [P25P2Decoder() for _ in range(C)]
        if wacn and sysid and nac:
            for ctx in self.ctxs:
                s = ctx.state
                s.p2_wacn, s.p2_sysid, s.p2_cc = wacn, sysid, nac
                s.nac = nac
        self.parse_cache = parse_cache
        self._pcache: list[dict] = [dict() for _ in range(C)]
        self._hit_def = _sync_def(self.SYNC_NAMES[0])
        self._scr_tables: dict = {}
        self.rs_fallbacks = 0
        self.crc_errors = 0
        self.last_xcch = None

    # -- host walk -----------------------------------------------------------------
    def pick_xcch(self, idx, vq, duid, isch, n_sym: int):
        """Accepted frames → the xCCH timeslot jobs (ch, tpos, sfpos,
        duid, slot): the control-channel counterpart of ``walk_frames``'
        voice selection, sharing its batched ISCH superframe
        resolution.  ``sfpos`` is -1 where no ISCH location word has been
        seen yet."""
        n_pat = self.tables.sync_len
        oka, sf_start_all = self._resolve_isch_batch(vq, isch)
        j_ch, j_tpos, j_sf, j_duid, j_slot = ([] for _ in range(5))
        for c in range(idx.shape[0]):
            ok = oka[c]
            if not ok.any():
                continue
            order = np.argsort(idx[c][ok], kind="stable")
            positions = idx[c][ok][order]
            duids_v = self._duid_lut[duid[c][ok][order]]        # [W, 4]
            sf_start = sf_start_all[c][ok][order]
            sf_pos = None
            last = -10 ** 9
            for w, t in enumerate(positions.tolist()):
                if (t - last < P2_FRAME_DIBITS - 8
                        or t + P2_FRAME_DIBITS >= n_sym):
                    continue
                last = t
                for ts in range(4):
                    s = int(sf_start[w][ts])
                    if s >= 0:
                        sf_pos = s
                    # -1: the superframe position is unresolved, so a
                    # scrambled burst can be neither descrambled nor
                    # accumulated for the blind recovery at a guessed
                    # position (the serial guard skips sf_pos=None)
                    p = sf_pos if sf_pos is not None else -1
                    if sf_pos is not None:
                        sf_pos = (sf_pos + 1) % 12
                    d = int(duids_v[w][ts])
                    if d in self.XCCH_DUIDS:
                        j_ch.append(c)
                        j_tpos.append(t + n_pat + TS_DIBITS * ts)
                        j_sf.append(p)
                        j_duid.append(d)
                        j_slot.append(ts % 2)
        if not j_ch:
            return tuple(np.zeros(0, np.int32) for _ in range(5))
        return tuple(np.asarray(a, np.int32)
                     for a in (j_ch, j_tpos, j_sf, j_duid, j_slot))

    def _scramble_table(self, key) -> np.ndarray:
        tbl = self._scr_tables.get(key)
        if tbl is None:
            tbl = p2_xcch.generate_scramble_bits(*key, SCRAMBLE_BITS)
            self._scr_tables[key] = tbl
        return tbl

    def gather_xcch(self, dibits_dev, ch, tpos) -> np.ndarray:
        """The picked timeslots' packed bytes ``[N, 45]`` on the host
        (the jobs padded to 64s, as the JAX package pads them)."""
        N = ch.shape[0]
        Np = -(-N // 64) * 64
        dev = self.device
        return p2_xcch_gather_device(
            dibits_dev, _padded(ch, Np, self.C, dev),
            _padded(tpos, Np, 0, dev)).cpu().numpy()[:N]

    def screen_xcch(self, packed, ch, sfp, duidv):
        """The host screen of the packed bursts: unpack, descramble with
        each channel's LFSR table at each timeslot's superframe position
        (+20 bit alignment, ``P25P2Decoder._descramble``), and the two
        float32 products per burst kind (numpy takes float32 products
        through BLAS; the sums are at most 360, so they are exact).
        Returns (raw bits ``[N, 360]``, descrambled bits, ``have``: the
        burst can be descrambled, ``res_ok``: its RS parity is
        consistent, ``crc_ok``: its CRC12 holds)."""
        bits = np.unpackbits(packed, axis=1)                    # [N, 360]
        N = bits.shape[0]
        # per-burst flags from 16-entry DUID tables, and the masks built
        # with one fancy-gather per distinct scramble key
        scr_lut = np.zeros(16, dtype=bool)
        kind_lut = np.zeros(16, dtype=np.int8)
        for d, (kind, scr, _l) in self.XCCH_DUIDS.items():
            scr_lut[d] = scr
            kind_lut[d] = 0 if kind == "sacch" else 1
        scrambled = scr_lut[duidv]
        keys = [(c.state.p2_wacn, c.state.p2_sysid, c.state.p2_cc)
                for c in self.ctxs]
        key_ok = np.asarray([all(k) for k in keys], dtype=bool)
        have = key_ok[ch] & (~scrambled | (sfp >= 0))
        mask = np.zeros_like(bits)
        need = scrambled & have
        if need.any():
            uniq: dict = {}
            gid = np.asarray([uniq.setdefault(k, len(uniq)) for k in keys],
                             dtype=np.int32)
            bgid = gid[ch]
            off360 = np.arange(360)
            for key, g in uniq.items():
                if not all(key):
                    continue
                sel = need & (bgid == g)
                if not sel.any():
                    continue
                base = 360 * sfp[sel] + 20
                mask[sel] = self._scramble_table(key)[base[:, None] + off360]
        x = bits ^ mask
        idxmap = _xcch_index_arrays()
        res_ok = np.zeros(N, dtype=bool)
        crc_ok = np.zeros(N, dtype=bool)
        kinds = kind_lut[duidv]
        for kb, kind in ((0, "sacch"), (1, "facch")):
            sel = np.flatnonzero(kinds == kb)
            if sel.size == 0:
                continue
            pay_i, par_i = idxmap[kind]
            pays = x[sel][:, pay_i]
            pars = x[sel][:, par_i]
            M = p2_xcch.xcch_encode_matrix(kind).astype(np.float32)
            res = (pays.astype(np.float32) @ M).astype(np.int32)
            res_ok[sel] = (res % 2 == pars).all(axis=1)
            nd = 168 if kind == "sacch" else 144
            T12 = p2_xcch.crc12_matrix(nd).astype(np.float32)
            crc = (pays[:, :nd].astype(np.float32) @ T12).astype(np.int32) % 2
            crc_ok[sel] = ((crc ^ 1)                         # 0xFFF inverted
                           == pays[:, nd:nd + 12]).all(axis=1)
        return bits, x, have, res_ok, crc_ok

    def decode_block_events(self, iq) -> int:
        """One ``[C, B]`` block end to end; events land in
        ``ctxs[c].events``.  Returns the number of MAC PDUs parsed."""
        return self.events_from_frontend(
            self.frontend_finish(self.frontend_dispatch(iq)))

    def events_from_frontend(self, fe6) -> int:
        """Pick, device gather, host screen and the per-burst parse from
        a finished front end; returns the number of MAC PDUs parsed."""
        dibits_dev, idx, vq, duid, isch, n_sym = fe6
        ch, tpos, sfp, duidv, slotv = self.pick_xcch(idx, vq, duid, isch,
                                                     n_sym)
        N = ch.shape[0]
        if N == 0:
            self.last_xcch = None
            return 0
        packed = self.gather_xcch(dibits_dev, ch, tpos)
        self.last_xcch = (ch, tpos, sfp, duidv, packed)
        raw, x, have, res_ok, crc_ok = self.screen_xcch(packed, ch, sfp,
                                                        duidv)
        pay_idx = {k: v[0] for k, v in _xcch_index_arrays().items()}
        n_parsed = 0
        for i in range(N):
            c, t, p = int(ch[i]), int(tpos[i]), int(sfp[i])
            kind, scr, lcch = self.XCCH_DUIDS[int(duidv[i])]
            slot = int(slotv[i])
            ctx, dec = self.ctxs[c], self.decs[c]
            hit = SyncHit(pos=t, score=1.0, sync=self._hit_def)
            if scr and not have[i]:
                s = ctx.state
                if all((s.p2_wacn, s.p2_sysid, s.p2_cc)) and p >= 0:
                    # the blind recovery succeeded earlier in this block
                    # (have[] was computed before the loop): decode with
                    # the recovered parameters instead of solving the
                    # seed again and emitting the recovery once more
                    dec.sf_pos = p
                    detail = dec._xcch(raw[i], 0, kind, scrambled=True,
                                       lcch=lcch, ctx=ctx, have_params=True,
                                       hit=hit, slot=slot)
                    if detail and "ERR" in detail:
                        self.crc_errors += 1
                    else:
                        n_parsed += 1
                    continue
                # the blind recovery: the serial decoder accumulates
                # bursts; once solved, later blocks take the fast screen.
                # An unresolved superframe position sets sf_pos=None, so
                # the serial guard skips the burst instead of feeding the
                # recovery a wrong position
                dec.sf_pos = p if p >= 0 else None
                dec._xcch(raw[i], 0, kind, scrambled=True, lcch=lcch,
                          ctx=ctx, have_params=False, hit=hit, slot=slot)
                continue
            if res_ok[i] and (lcch or crc_ok[i]):
                n_parsed += 1
                self._parse_mac(c, t, kind, x[i][pay_idx[kind]], slot, dec)
            else:
                # channel errors: the serial RS(63,35) erasure decode
                self.rs_fallbacks += 1
                dec.sf_pos = p if p >= 0 else None
                detail = dec._xcch(raw[i], 0, kind, scrambled=scr, lcch=lcch,
                                   ctx=ctx, have_params=True, hit=hit,
                                   slot=slot)
                if detail and "ERR" in detail:
                    self.crc_errors += 1
                else:
                    n_parsed += 1
        return n_parsed

    def _parse_mac(self, c: int, t: int, kind: str, payload: np.ndarray,
                   slot: int, dec) -> None:
        """Host MAC-PDU walk of one clean xCCH payload, with the
        payload-keyed parse cache (control channels repeat the same PDUs
        many times a second; see ``BatchedP25ControlPipeline``)."""
        ctx = self.ctxs[c]
        iden_v = getattr(getattr(ctx.state, "iden_table", None),
                         "version", 0)
        key = (payload.tobytes(), kind, slot & 1, iden_v)
        if self.parse_cache:
            hitv = self._pcache[c].get(key)
            if hitv is not None:
                for line, fields in hitv:
                    ctx.emit(line, "p25p2", t, **fields)
                return
        hit = SyncHit(pos=t, score=1.0, sync=self._hit_def)
        n0 = len(ctx.events)
        detail = dec._mac_pdu(payload, kind, ctx, hit, slot)
        name = {"sacch": "SACCH", "facch": "FACCH"}[kind]
        ctx.emit(f"       P25p2 {name}{detail}", "p25p2", t, slot=slot)
        if self.parse_cache:
            pc = self._pcache[c]
            if len(pc) >= PARSE_CACHE_MAX:
                pc.clear()
            pc[key] = [(e.line, dict(e.fields)) for e in ctx.events[n0:]]

    def events(self, c: int):
        return self.ctxs[c].events
