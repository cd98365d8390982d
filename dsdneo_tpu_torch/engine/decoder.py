"""Offline decode: one channel of baseband → events and PCM.

The port's counterpart of ``decode_samples``, ``detect_mode`` and
``decode_capture`` in ``dsdneo_tpu/engine/decoder.py`` (the rebuild of
the reference's liveScanner main loop, src/engine/engine.c:2406-2439):
the front end runs on the device (``engine.demod.demod_fm`` or, for
CQPSK, ``demod_cqpsk_path``), the dibit and soft streams come to the
host once, the host hunts frame sync in them
(``symbols.framesync.find_syncs``) and hands each hit to its family's
serial decoder, which walks the streams with a ``DibitReader`` and
emits events; the voice decoders synthesize PCM on the same device.

Every family has its serial decoder, registered when this module is
imported: P25 Phase 1 (``p25p1``), P25 Phase 2 (``p25p2``: the
4-timeslot walk, xCCH MAC PDUs, the blind scramble recovery, 4V/2V
AMBE voice with ADP), DMR (``dmr``: the BS/MS/DM bursts with their
data, CSBK, SLC, UDT, late-entry and voice-cipher modules), X2-TDMA
(``x2tdma``), EDACS (``edacs``), ProVoice (``provoice``), NXDN
(``nxdn48``, ``nxdn96``), dPMR (``dpmr``), YSF (``ysf``), D-STAR
(``dstar``) and M17 (``m17``: LSF, stream with Codec2 voice, the
scrambler, AES-CTR and signed streams, packets, BERT).  ``mode="auto"``
picks the mode with :func:`detect_mode`; :func:`decode_capture` reads
an I/Q capture and resamples it to ``DSD_NEO_RESAMP`` on the device
first.  All three take the card when no device is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dsdneo_tpu_torch.engine.demod import (_device, demod_cqpsk_path,
                                           demod_fm)
from dsdneo_tpu_torch.engine.modes import MODES, ModeConfig
from dsdneo_tpu_torch.io import read_iq_capture
from dsdneo_tpu_torch.protocol import base as proto_base
# importing the decoders registers them
import dsdneo_tpu_torch.protocol.dmr  # noqa: F401
import dsdneo_tpu_torch.protocol.dpmr.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.dstar.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.edacs.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.m17.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.nxdn.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.p25.phase1  # noqa: F401
import dsdneo_tpu_torch.protocol.p25.phase2  # noqa: F401
import dsdneo_tpu_torch.protocol.provoice.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.x2tdma  # noqa: F401
import dsdneo_tpu_torch.protocol.ysf.decoder  # noqa: F401
from dsdneo_tpu_torch.symbols import framesync


def decode_samples(samples: np.ndarray, mode: ModeConfig | str,
                   fs: float = 48000.0, sync_threshold: float = 0.62,
                   verbose: int = 0, cqpsk: bool = False,
                   p2_params: tuple[int, int, int] | None = None,
                   call_recorder=None, keyring=None,
                   mbe_sink=None, m17_udp=None,
                   state_attrs: dict | None = None,
                   device=None) -> proto_base.DecoderContext:
    """Decode one channel of complex baseband samples end to end.

    ``p2_params`` optionally seeds (WACN, SYSID, NAC) for the P25p2
    descrambler (the reference's -X flag).  ``mode="auto"`` picks the
    mode with :func:`detect_mode` first.  The front end and the voice
    synthesis run on ``device``: the card when none is given (raises
    when there is none)."""
    if isinstance(mode, str):
        mode = MODES[mode]
    dev = _device(device)
    if mode.name == "auto":
        mode = detect_mode(samples, fs, sync_threshold, device=dev)
    if cqpsk:
        dibits, norm = demod_cqpsk_path(samples, mode, fs, device=dev)
    else:
        dibits, norm = demod_fm(samples, mode, fs, device=dev)
    return _walk(samples, mode, dibits, norm, sync_threshold, dev,
                 verbose=verbose, p2_params=p2_params,
                 call_recorder=call_recorder, keyring=keyring,
                 mbe_sink=mbe_sink, m17_udp=m17_udp,
                 state_attrs=state_attrs)


def _walk(samples: np.ndarray, mode: ModeConfig, dibits: np.ndarray,
          norm: np.ndarray, sync_threshold: float, dev: torch.device,
          verbose: int = 0, p2_params=None, call_recorder=None,
          keyring=None, mbe_sink=None, m17_udp=None,
          state_attrs: dict | None = None) -> proto_base.DecoderContext:
    """The host part of :func:`decode_samples`: the sync hunt in the
    front end's streams and the serial decoders' walk."""
    defs = framesync.patterns_for(set(mode.protocols))
    hits = framesync.find_syncs(norm, defs, threshold=sync_threshold)

    ctx = proto_base.DecoderContext(verbose=verbose, device=dev)
    ctx.call_recorder = call_recorder
    ctx.state.keyring = keyring
    ctx.mbe_sink = mbe_sink
    ctx.m17_udp = m17_udp
    for k, v in (state_attrs or {}).items():
        setattr(ctx.state, k, v)
    if p2_params is not None:
        ctx.state.p2_wacn, ctx.state.p2_sysid, ctx.state.p2_cc = p2_params
    ctx.mode_name = mode.name
    ctx.debug_soft = norm
    ctx.dibits = dibits          # -c symbol capture source
    ctx.debug_iq = samples[:16384]
    ctx.n_syncs = len(hits)
    ctx.sync_scores = [h.score for h in hits]
    registry = proto_base.registry()
    decoders: dict[str, proto_base.ProtocolDecoder] = {}
    consumed_until = 0
    force_pol = getattr(ctx.state, "force_polarity", None)
    for hit in hits:
        if hit.pos < consumed_until:
            continue
        if force_pol:
            # -x inversion expectations (reference opts->inverted_*):
            # drop sync hypotheses at the unexpected polarity, or
            # reinterpret a polarity-ambiguous hit as its same-pattern
            # twin (DMR's inverted syncs are the opposite burst type's
            # normal syncs; reference inverted_dmr semantics).
            want = force_pol.get(hit.sync.protocol)
            if want is not None and bool(hit.sync.inverted) != want:
                twin = framesync.polarity_twin(hit.sync) if want else None
                if twin is None:
                    continue
                hit = dataclasses.replace(hit, sync=twin)
        dec = decoders.setdefault(hit.sync.protocol,
                                  registry[hit.sync.protocol]())
        reader = proto_base.DibitReader(
            dibits, norm, pos=hit.end, frame_start=hit.pos,
            invert=hit.sync.inverted)
        consumed_until = dec.handle(reader, hit, ctx)
    return ctx


def _device_error(e: Exception) -> bool:
    """Whether ``e`` came from the device (a CUDA error, out of memory)
    rather than from a host decoder."""
    if isinstance(e, (torch.cuda.OutOfMemoryError,
                      getattr(torch, "AcceleratorError", ()))):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


def detect_mode(samples: np.ndarray, fs: float = 48000.0,
                sync_threshold: float = 0.62, device=None) -> ModeConfig:
    """Auto mode: run each demod configuration (symbol rate, slicing,
    channel filter) over a probe slice and keep the one whose own
    protocols' sync patterns correlate best — the rebuild of the
    reference's modulation auto-switch hunt (src/dsp/dsd_frame_sync.c
    getFrameSync with opts->mod_* auto).  The probe's front ends run on
    ``device`` (the card when none is given).  A mode whose host decode
    raises is skipped, as in the JAX package; an error of the device
    (the front end's, or the synthesis') propagates."""
    dev = _device(device)
    # probe the middle of the capture (lead-ins are often dead air)
    half = len(samples) // 2
    w = int(fs * 2.0)
    probe = samples[max(half - w, 0):half + w]
    best, best_score = MODES["p25p1"], -1e9
    for name, cfg in MODES.items():
        if name in ("auto", "provoice", "x2tdma"):
            continue          # duplicate configs of other rows
        dibits, norm = demod_fm(probe, cfg, fs, device=dev)
        try:
            ctx = _walk(probe, cfg, dibits, norm, sync_threshold, dev)
        except Exception as e:
            if _device_error(e):
                raise
            continue
        # score on structured decode evidence, not display strings:
        # events that carry parsed payload fields got there through
        # FEC/CRC validation (NID BCH, slot-type Golay, CRC-gated
        # headers), while noise-tripped syncs emit bare lines or only
        # bookkeeping keys.  Error lines count against (failed FEC on a
        # wrong-rate slicer is the common false-sync signature).
        bookkeeping = {"slot", "voice", "imbe", "ambe216"}
        score = 0.0
        for e in ctx.events:
            is_err = "ERR" in e.line or "FAIL" in e.line
            if is_err:
                score -= 0.25
                continue
            nfields = sum(1 for k, v in e.fields.items()
                          if k not in bookkeeping
                          and not isinstance(v, np.ndarray))
            score += min(nfields, 3)
        if score > best_score:
            best, best_score = cfg, score
    return best


def decode_capture(path: str, mode: ModeConfig | str, device=None, **kw
                   ) -> proto_base.DecoderContext:
    """Decode an on-disk I/Q capture (``.iq`` / ``.iq.json``).

    DSD_NEO_RESAMP (reference docs/cli.md:537 — default 48000, ``off``
    keeps the capture's native rate): a capture at another rate is
    resampled to the target DSP rate first, by ``dsp.resampler`` on
    ``device`` (the card when none is given), which the decode then
    runs on."""
    from dsdneo_tpu_torch.dsp.resampler import resample
    from dsdneo_tpu_torch.runtime import config as rtcfg
    dev = _device(device)
    meta, samples = read_iq_capture(path)
    fs = float(meta.sample_rate_hz)
    target = rtcfg.get().resamp_hz
    if target > 0 and float(target) != fs:
        x = torch.from_numpy(samples).to(dev)
        samples = resample(x, int(round(fs)), int(target)).cpu().numpy()
        fs = float(target)
    return decode_samples(samples, mode, fs=fs, device=dev, **kw)
