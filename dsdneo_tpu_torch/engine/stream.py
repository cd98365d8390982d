"""Streaming decode: blockwise I/Q push with carry across blocks.

The port's own copy of ``dsdneo_tpu/engine/stream.py``, unchanged in its
dispatch rules; each window's front end (``engine.demod.demod_fm``, or
``demod_disc`` for discriminator PCM) runs on the decoder's device (the
card when none is given), and the host decoders of ``engine.decoder``
walk its dibit and soft streams, synthesizing voice on the same device.

The live analog of the reference's demod-thread loop (src/io/radio/
rtl_sdr_fm.cpp demod_thread_fn consuming the input ring blockwise,
with filter/timing state carried in demod_state).  Here the carry is
an overlap window of raw samples: each push demodulates
``[tail | new block]`` and dispatches only frames not already
dispatched from a previous window.

Dispatch discipline (deterministic, reference carry analog
rtl_sdr_fm.cpp:3484-3488):

- **dedup ledger**: every dispatched frame is recorded as
  (protocol, global symbol position); a hit is a duplicate iff the
  same protocol was dispatched within ±2 symbol periods of its global
  position (re-demodulating a longer window can shift the recovered
  symbol grid by a symbol, and a marginal frame can correlate under a
  different sync variant of the same protocol in the next window).
- **holdback by frame extent**: a hit waits for the next window when
  its protocol's maximum frame extent crosses the end of the current
  window, so partially received frames are never parsed early.
- **canonical windows**: processing advances in absolute segments of
  0.2 s — window k covers samples [k·S − overlap, (k+1)·S), boundaries
  independent of how the caller splits pushes.  Since the demodulator
  estimates timing/gain per window, canonical boundaries make every
  decode decision split-invariant: pushing the capture in any block
  sizes yields EXACTLY the same events (asserted by the boundary-sweep
  test).

The overlap must cover the longest protocol frame extent (a DMR voice
superframe read-ahead ≈ 0.32 s) plus filter warm-up; 0.45 s is used.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dsdneo_tpu_torch.engine.demod import _device, demod_disc, demod_fm
from dsdneo_tpu_torch.engine.modes import MODES, ModeConfig
from dsdneo_tpu_torch.protocol import base as proto_base
import dsdneo_tpu_torch.engine.decoder  # noqa: F401  (registers protocol decoders)
from dsdneo_tpu_torch.symbols import framesync

# maximum frame extent in dibits past the sync start, per protocol —
# how much stream a decoder may consume for one frame (P25 LDU: 24 sync
# + 32 NID + 784 data + status ≈ 870; others far less)
_FRAME_EXTENT = {
    "p25p1": 900,               # LDU: 24 sync + 32 NID + 784 data + status
    "p25p2": 740,               # 20 sync + 700 dibits (4-burst frame)
    # a DMR voice superframe is read ahead from the VC1 sync:
    # 5 × 288-dibit bursts + the trailing half payload ≈ 1520
    "dmr": 1550,
    "nxdn48": 200, "nxdn96": 200,
    "dpmr": 400,                # FS2 payload walk (measured 384)
    "dstar": 2050,              # voice super-sequence consume (2016)
    "ysf": 500,                 # 480-dibit FICH+payload frame
    "m17": 200,
    "edacs": 300,               # measured 288
    "provoice": 300,
    "x2tdma": 200,
}
_DEFAULT_EXTENT = 900


class StreamDecoder:
    """Push-driven single-channel decoder with cross-block carry."""

    def __init__(self, mode: ModeConfig | str, fs: float = 48000.0,
                 sync_threshold: float = 0.62, overlap_s: float = 0.45,
                 ctx: proto_base.DecoderContext | None = None,
                 input_kind: str = "iq", device=None):
        self.mode = MODES[mode] if isinstance(mode, str) else mode
        self.fs = fs
        self.sync_threshold = sync_threshold
        self.overlap = int(fs * overlap_s)
        # the front ends and the synthesis run here: the card when no
        # device is given (raises when there is none)
        self.device = _device(device)
        self.ctx = ctx or proto_base.DecoderContext(device=self.device)
        if self.ctx.device is None:
            self.ctx.device = self.device
        # "iq" = complex baseband; "disc" = demodulated discriminator
        # PCM (UDP/TCP sources) — timing+slicing only, no front end
        self.input_kind = input_kind
        self._dtype = np.complex64 if input_kind == "iq" else np.float32
        # protocol decoders read the active mode for rate-dependent
        # labels (e.g. NXDN48 vs NXDN96) — same as decode_samples
        self.ctx.mode_name = self.mode.name
        self._total = 0                 # global sample count pushed
        self._decoders: dict[str, proto_base.ProtocolDecoder] = {}
        self._defs = framesync.patterns_for(set(self.mode.protocols))
        self._sps = fs / self.mode.symbol_rate
        self.last_snr_db: float = 0.0   # bias-corrected eye/EVM SNR
        # dedup ledger: protocol -> sorted-ish list of global symbol
        # positions already dispatched (pruned as the stream advances)
        self._dispatched: dict[str, list[float]] = {}
        # global consumed-until (symbol position): alias hits inside an
        # already-decoded frame span must not re-dispatch from a later
        # window (the one-shot path's consumed_until, made global)
        self._consumed_gsym = -1e18

    # -- dedup ledger -------------------------------------------------------
    def _is_dup(self, name: str, gsym: float) -> bool:
        for p in self._dispatched.get(name, ()):
            if abs(p - gsym) <= 2.0:
                return True
        return False

    def _record(self, name: str, gsym: float) -> None:
        self._dispatched.setdefault(name, []).append(gsym)

    def _prune(self, min_gsym: float) -> None:
        for name, lst in self._dispatched.items():
            self._dispatched[name] = [p for p in lst if p >= min_gsym]

    # -- window processing ----------------------------------------------
    def _process(self, window: np.ndarray, base: int, final: bool) -> None:
        if self.input_kind == "disc":
            dibits, norm = demod_disc(window, self.mode, self.fs,
                                      device=self.device)
        else:
            dibits, norm = demod_fm(window, self.mode, self.fs,
                                    device=self.device)
        self.last_snr_db = self._eye_snr_db(norm)
        self.last_soft = norm[-2048:]      # visualizer eye buffer
        hits = framesync.find_syncs(norm, self._defs,
                                    threshold=self.sync_threshold)
        # DSD_NEO_DEBUG_SYNC: verbose sync detection (docs/cli.md:655)
        from dsdneo_tpu_torch.runtime import config as _rtcfg
        if _rtcfg.get().debug_sync and hits:
            from dsdneo_tpu_torch.runtime import log as _log
            for h in hits:
                _log.debug("SYNC %s%s @ sym %d (score %.2f)",
                           h.sync.name, " (inv)" if h.sync.inverted else "",
                           h.pos, getattr(h, "score", 0.0))
        registry = proto_base.registry()
        consumed_local = 0
        force_pol = getattr(self.ctx.state, "force_polarity", None)
        for hit in hits:
            gsym = (base / self._sps) + hit.pos   # global symbol position
            if hit.pos < consumed_local:
                continue
            if force_pol:
                # -x polarity expectations — same gate + DMR
                # twin-reinterpretation as the one-shot path
                # (engine/decoder.py)
                want = force_pol.get(hit.sync.protocol)
                if want is not None and bool(hit.sync.inverted) != want:
                    twin = framesync.polarity_twin(hit.sync) \
                        if want else None
                    if twin is None:
                        continue
                    hit = dataclasses.replace(hit, sync=twin)
            extent = _FRAME_EXTENT.get(hit.sync.protocol, _DEFAULT_EXTENT)
            if not final and hit.pos + extent > len(dibits):
                break                    # frame may be cut: wait for data
            if self._is_dup(hit.sync.protocol, gsym):
                continue
            if gsym < self._consumed_gsym - 2.0:
                continue                 # inside an already-decoded frame
            factory = registry.get(hit.sync.protocol)
            if factory is None:
                continue
            dec = self._decoders.setdefault(hit.sync.protocol, factory())
            reader = proto_base.DibitReader(
                dibits, norm, pos=hit.end, frame_start=hit.pos,
                invert=hit.sync.inverted)
            consumed_local = dec.handle(reader, hit, self.ctx)
            self._record(hit.sync.protocol, gsym)
            self._consumed_gsym = max(self._consumed_gsym,
                                      base / self._sps + consumed_local)
        self._prune((base - 2 * self.overlap) / self._sps)

    def _eye_snr_db(self, norm: np.ndarray) -> float:
        """Bias-corrected symbol SNR (reference snr_estimator.cpp eye
        method + snr_bias.cpp bandwidth/estimator correction)."""
        from dsdneo_tpu_torch.dsp.measure import snr_bias_db
        if norm.size < 64:
            return self.last_snr_db
        lv = np.array([1.0, 3.0, -1.0, -3.0]) if self.mode.four_level \
            else np.array([1.0, -1.0])
        d = np.min(np.abs(norm[:, None] - lv[None, :]), axis=1)
        noise = float(np.mean(d ** 2))
        sig = float(np.mean(norm ** 2))
        raw = 10.0 * np.log10(max(sig, 1e-9) / max(noise, 1e-9))
        kind = "c4fm" if self.mode.four_level else "evm"
        return raw - snr_bias_db(kind, float(self.mode.symbol_rate),
                                 self.mode.lpf_profile)

    @property
    def _seg(self) -> int:
        return int(self.fs * 0.2)       # canonical segment hop

    def push(self, block: np.ndarray) -> list:
        """Feed new complex samples; returns events emitted this push.
        Processing happens at canonical absolute-segment boundaries, so
        any split of the same stream produces identical events."""
        block = np.asarray(block, dtype=self._dtype)
        # buffer holds samples from self._buf_base onward
        if not hasattr(self, "_buf"):
            self._buf = np.zeros(0, self._dtype)
            self._buf_base = 0
            self._next_k = 0
        self._buf = np.concatenate([self._buf, block])
        self._total += len(block)
        n_before = len(self.ctx.events)
        S = self._seg
        while self._total >= (self._next_k + 1) * S:
            k = self._next_k
            # clamp to the buffer base: after a flush() the overlap
            # samples before _buf_base are gone, and an unclamped
            # start would slice negatively (garbage window, wrong
            # global positions) on a post-flush push
            start = max(self._buf_base, k * S - self.overlap)
            end = (k + 1) * S
            window = self._buf[start - self._buf_base:end - self._buf_base]
            # need one 256-symbol timing-estimation window + margin
            if len(window) >= int(max(self.fs * 0.05, 272 * self._sps)):
                self._process(window, start, final=False)
            self._next_k += 1
            # prune buffer to what the next window needs
            keep_from = max(0, self._next_k * S - self.overlap)
            if keep_from > self._buf_base:
                self._buf = self._buf[keep_from - self._buf_base:]
                self._buf_base = keep_from
        return self.ctx.events[n_before:]

    def flush(self) -> list:
        """Dispatch anything still held back (end of stream)."""
        n_before = len(self.ctx.events)
        if hasattr(self, "_buf") and self._total > self._buf_base:
            start = max(0, self._next_k * self._seg - self.overlap)
            window = self._buf[start - self._buf_base:]
            if len(window):
                self._process(window, start, final=True)
            self._buf = np.zeros(0, self._dtype)
            self._buf_base = self._total
            # resume cleanly if the caller pushes again: everything up
            # to _total is dispatched, so the next canonical segment
            # is the first one ending past _total
            self._next_k = -(-self._total // self._seg)
        return self.ctx.events[n_before:]
