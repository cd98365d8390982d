"""Offline decode: one channel of baseband → events and PCM.

The port's counterpart of ``decode_samples`` in
``dsdneo_tpu/engine/decoder.py`` (the rebuild of the reference's
liveScanner main loop, src/engine/engine.c:2406-2439): the front end
runs on the device (``engine.demod.demod_fm`` or, for CQPSK,
``demod_cqpsk_path``), the dibit and soft streams come to the host once,
the host hunts frame sync in them (``symbols.framesync.find_syncs``) and
hands each hit to its family's serial decoder, which walks the streams
with a ``DibitReader`` and emits events; the voice decoders synthesize
PCM on the same device.

The port's serial decoders are those of P25 Phase 1 (``p25p1``), DMR
(``dmr``: the BS/MS/DM bursts with their data, CSBK, SLC, UDT, late-entry
and voice-cipher modules), X2-TDMA (``x2tdma``), EDACS (``edacs``),
ProVoice (``provoice``), NXDN (``nxdn48``, ``nxdn96``: LICH, SACCH
superframes, FACCH1, CAC and AMBE voice), dPMR (``dpmr``), YSF (``ysf``:
FICH, DCH2 and the V/D1, V/D2 and full-rate voice modes) and D-STAR
(``dstar``: the RF header, slow data and the AMBE 3600x2400 ECC),
registered when this module is imported.  A mode that hunts a family
the port has no serial decoder for (M17, P25 Phase 2) raises
``NotImplementedError`` naming the family, and so does ``mode="auto"``
(``detect_mode`` tries every family).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dsdneo_tpu_torch.device import require_cuda
from dsdneo_tpu_torch.engine.demod import demod_cqpsk_path, demod_fm
from dsdneo_tpu_torch.engine.modes import MODES, ModeConfig
from dsdneo_tpu_torch.protocol import base as proto_base
# importing the decoders registers them
import dsdneo_tpu_torch.protocol.dmr  # noqa: F401
import dsdneo_tpu_torch.protocol.dpmr.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.dstar.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.edacs.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.nxdn.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.p25.phase1  # noqa: F401
import dsdneo_tpu_torch.protocol.provoice.decoder  # noqa: F401
import dsdneo_tpu_torch.protocol.x2tdma  # noqa: F401
import dsdneo_tpu_torch.protocol.ysf.decoder  # noqa: F401
from dsdneo_tpu_torch.symbols import framesync


def _check_families(mode: ModeConfig) -> None:
    if mode.name == "auto":
        raise NotImplementedError(
            "mode 'auto' (detect_mode) needs every protocol family's "
            "serial decoder; the port has "
            + ", ".join(sorted(proto_base.registry())))
    missing = sorted(mode.protocols - set(proto_base.registry()))
    if missing:
        raise NotImplementedError(
            f"mode {mode.name!r}: the port has no serial decoder for "
            + ", ".join(missing))


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
    descrambler (the reference's -X flag).  The front end and the voice
    synthesis run on ``device``: the card when none is given (raises
    when there is none)."""
    if isinstance(mode, str):
        mode = MODES[mode]
    _check_families(mode)
    dev = require_cuda() if device is None else device
    if cqpsk:
        dibits, norm = demod_cqpsk_path(samples, mode, fs, device=dev)
    else:
        dibits, norm = demod_fm(samples, mode, fs, device=dev)
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
