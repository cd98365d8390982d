"""Export the constant tables and the test vectors of the ported voice
paths from the JAX package into ``dsdneo_tpu_torch/data/``:
``p25p1_tables.npz`` (P25 Phase 1, C4FM and CQPSK), ``dmr_tables.npz``
(DMR BS two-slot voice and the AMBE core) and ``tdma_tables.npz``
(the front ends and host tables of X2-TDMA, P25 Phase 2 and NXDN, whose
AMBE core is the DMR file's).

The PyTorch port (``dsdneo_tpu_torch``) never imports JAX, so every
constant it needs is built here, from the JAX package's own functions,
as plain numpy arrays:

  - the 143-tap P25 C4FM channel low-pass (dsp.firdes.channel_lpf);
  - the mode constants (engine.modes.MODES["p25p1"]);
  - the ±P25p1 frame-sync patterns (symbols.framesync.SYNC_DEFS);
  - the IMBE ECC tables (fec.device._imbe_consts and the learned
    Hamming(15,11) codebook);
  - the stacked IMBE dequantization tables (vocoder.device._stacked_tables)
    and the scalar vocoder constants;
  - the IMA ADPCM tables (ops.audio_wire);
  - the synthesis noise-grid bases (vocoder.synth).

For DMR (:func:`build_dmr_tables`):

  - the 143-tap 12.5 kHz channel low-pass and the mode constants
    (engine.modes.MODES["dmr"]);
  - the ±DMR BS voice sync patterns;
  - the AMBE ECC tables (fec.device._ambe_consts) and the Golay(23,12)
    codebook;
  - the QR(16,7,6) codebook of the EMB gate (fec.blockcodes.qr_16_7_6);
  - the AMBE dequantization tables (vocoder.device._ambe_tables);
  - the IMA ADPCM tables and the synthesis noise-grid bases, as above;
  - the test vector: the dibits of
    ``engine.dmrbatch.synth_voice_stream(8, seed=1)`` and the 49
    parameter bits of its 2 x 144 voice frames.

For X2-TDMA, P25 Phase 2 and NXDN (:func:`build_tdma_tables`):

  - the channel low-passes ``12k5``, ``p25_c4fm`` and ``6k25`` and the
    symbol rates of ``x2tdma``, ``p25p2``, ``nxdn48``, ``nxdn96``
    (engine.modes.MODES);
  - the sync level rows ``+X2-TDMA BS voice`` / ``+X2-TDMA MS voice``,
    ``+P25p2`` and ``±NXDN FSW``, with their ``inverted`` flags;
  - the GF(64) exp and log tables (fec.rs), the 256-entry P25p2 DUID
    lookup and the ISCH table as sorted keys and values
    (protocol.p25.phase2, protocol.p25.p2_xcch), the NXDN PN9 scramble
    positions (protocol.nxdn.decoder);
  - the test vectors: the dibits and ``bits49`` of
    ``x2batch.synth_x2_voice_stream(8, seed=1)`` and of
    ``p2batch.synth_p2_voice_stream(8, seed=1)`` (the bench's streams),
    of an ADP-encrypted P25p2 stream, and of :func:`synth_nxdn_voice_stream`,
    an NXDN full-voice stream built by inverting the decoder's tables.

For the control-channel monitors (:func:`build_cc_tables`, into
``cc_tables.npz``):

  - the P25 trellis constants (fec.device._p25_trellis_consts), the
    CRC16 contribution table, the TSDU block offsets, the BPTC(196,96)
    gather with the Hamming(15,11) and (13,9) codebooks, the
    Golay(20,8) codebook, the DMR slot-type and payload offsets, the
    ``+DMR BS data`` / ``+DMR BS voice`` sync rows, the NXDN CAC
    constants and the K=5 code's output tables (engine.ccbatch,
    fec.conv);
  - one test vector per monitor: a P25 control channel of back-to-back
    TSDUs of three TSBKs each (protocol.p25.encode.tsdu_frame), a DMR
    Tier III channel of CSBK bursts (protocol.dmr.encode.cc_stream_dibits)
    and an NXDN RCCH of CAC frames (the construction of
    tests/test_ccbatch.py, RAN 5, LICH 0x01), each with the payload bytes
    of every block it carries and the event lines the JAX package's
    catalogs emit for them (a unicode array with the index of the block
    each line belongs to).  Every line is checked to come out the same
    when the stream is parsed a second time in the same context, so a
    monitor that parses any prefix of a stream, once or twice, emits the
    lines of its blocks.

For the event pipelines (:func:`build_event_tables`, into
``event_tables.npz``):

  - the D-STAR AMBE ECC's row positions, PN rows, parities and
    messages (as ``fec.device._dstar_ambe_jit`` builds them) with the
    Golay(23,12) codebook, and the Golay(24,12) codebook of M17's LICH;
  - a bursty D-STAR stream: transmissions of a 64-symbol preamble, the RF
    header (41 octets through the K=3 code, the interleave and the
    scramble), 2-4 voice superframes (AMBE frames through
    ``encode_dstar_ambe_ecc``, slow data with the header's copy, radio
    text or a DPRS position), the end pattern and dead air (dibit value
    4, zero I/Q when modulated);
  - a bursty M17 stream of ``encode_stream_transmission`` transmissions
    (known LSFs, random Codec2 payloads) with dead air between them;
  - each stream held to the JAX pipeline on three channels of a 3 s
    block before it is written: every header, partnered superframe and
    stream frame the block holds accepted with the stream's content,
    nothing else emitting, every LSF assembled (the port's
    ``protocol.dstar.encode.judge`` and ``protocol.m17.encode.judge``).

For the other paths behind the gated front end (:func:`build_burst_tables`,
into ``burst_tables.npz``), three streams the JAX package has no
generator for, built by inverting its own tables:

  - a bursty YSF stream: transmissions of V/D2 frames (the ``+YSF``
    sync, a FICH field of random dibits, five blocks of 20 random data
    dibits and 52 voice dibits: an AMBE frame with its 27 protected bits
    tripled, PN95-whitened and interleaved, the inverse of
    ``engine.ysfbatch._vd2_tables``), the first of each transmission and
    about one in six of the others data frames with random voice blocks,
    between an alternating preamble and postamble, then dead air;
  - a bursty dPMR stream: transmissions of FS2 parts (the ``+dPMR FS2``
    sync, random control dibits and eight ``encode_ambe_ecc`` frames at
    ``engine.dpmrbatch._voice_offsets``), framed the same way;
  - a continuous EDACS control channel: frames of the ``+EDACS`` sync and
    two BCH(40,28) words of standard and extended-addressing messages,
    each sent three times with the middle copy complemented, with the
    JAX catalogs' event lines of every frame read three ways (standard,
    EA, and standard after the ESK mask);
  - every stream drawn again where a clean false sync would reach a
    margin under the pick's threshold at a position where it could take
    a frame's place, and held to the JAX pipeline before it is written
    (YSF and dPMR on 3 s blocks, EDACS on 1 s blocks, where the JAX
    monitor's top 96 holds every frame; dPMR and EDACS with an inverted
    channel, EDACS read in the three modes), its accepted frames kept as
    ``<kind>_tv_jax_frames``.

``serial_tables.npz`` holds the serial decode path's eleven 60 s
streams (``build_serial_tables``): a P25 Phase 1 call, EDACS with
ProVoice, a DMR BS stream, X2-TDMA, an NXDN traffic channel (NXDN96,
and NXDN48 from the same dibits), a dPMR, a YSF, a D-STAR and an M17
channel, and a P25 Phase 2 channel, each held to the JAX
``decode_samples`` over its whole length through its judge in
``engine.serialvec``.  Every stretch the serial hunt reads outside a
frame is drawn clean of false syncs (``_hunted_fill``), and a frame
whose end could shadow the next sync is drawn again (``_frame_ok``,
M17's ``_m17_shadowed``).

The P25 file also holds one test vector: a synthesized P25p1 dibit stream of 16
LDUs (~3 s at 4800 baud) built with protocol.p25.encode, the 88 IMBE
parameter bits of its 144 voice frames, the LDU start positions, and
random lead/tail filler whose sync correlation stays far below the
picker's threshold, so any leading offset the caller cuts from the lead
still yields exactly 16 LDUs.

Run from the repository root, where JAX is installed:

    python tools/export_torch_tables.py

A file whose arrays already equal the rebuilt ones is left untouched.
``tests/test_torch_tables.py`` rebuilds the arrays with ``build_tables``,
``build_dmr_tables``, ``build_tdma_tables``, ``build_cc_tables``,
``build_event_tables``, ``build_burst_tables`` and
``build_serial_tables`` and checks them against the checked-in files.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "dsdneo_tpu_torch", "data")
OUT = os.path.join(DATA, "p25p1_tables.npz")
OUT_DMR = os.path.join(DATA, "dmr_tables.npz")
OUT_TDMA = os.path.join(DATA, "tdma_tables.npz")
OUT_SERIAL = os.path.join(DATA, "serial_tables.npz")

TV_NAC = 0x293
TV_N_LDUS = 16
TV_LDU_SEED = 11          # encode.random_voice_ldus seed
TV_FILLER_SEED = 5        # first filler seed tried
TV_LEAD = 256             # lead filler dibits (callers cut a suffix)
TV_TAIL = 640             # tail filler dibits after the last LDU
# largest |sync correlation| allowed anywhere off the true sync starts;
# the pipeline's threshold is 0.62
TV_FALSE_SYNC_MAX = 0.5
DMR_TV_SUPERFRAMES = 8    # engine.dmrbatch.synth_voice_stream arguments,
DMR_TV_SEED = 1           # as the JAX package's bench calls it
X2_TV = (8, 1)            # synth_x2_voice_stream(n_superframes, seed)
P2_TV = (8, 1)            # synth_p2_voice_stream(n_superframes, seed)
# the ADP/RC4 stream of the JAX package's P25p2 crypto test:
# (n_superframes, seed, alg, kid, key, mi)
P2_ADP_TV = (4, 3, 0xAA, 0x0123, 0x1234567890, 0xA5A5F00D5EED0001)
NXDN_TV_FRAMES = 36       # 80 ms frames: 2.88 s of NXDN48 voice
NXDN_TV_SEED = 1
NXDN_TV_TAIL = 400        # unmodulated dibits after the last frame
NXDN_FULL_VOICE_LICH = 0x36
OUT_CC = os.path.join(DATA, "cc_tables.npz")
CC_NAC = 0x293            # the P25 control channel's NAC
CC_P25_SEED = 9
CC_DMR_SEED = 10
CC_DMR_COLOR = 1
CC_NXDN_SEED = 3          # tests/test_ccbatch.py _build_cac_stream
CC_NXDN_RAN = 5
# every stream covers a 3 s block at 48 kHz after a lead of up to 96
# dibits: P25 and DMR at 4800 symbols/s, NXDN48 at 2400
CC_MIN_DIBITS = {"p25": 14400 + 96, "dmr": 14400 + 96, "nxdn": 7200 + 96}


def _sync_corr(dibits: np.ndarray, levels: np.ndarray) -> np.ndarray:
    """Normalized correlation of the ideal symbol levels of ``dibits``
    with one sync pattern at every start position."""
    lv = np.array([1.0, 3.0, -1.0, -3.0])[dibits]
    n = len(levels)
    win = np.lib.stride_tricks.sliding_window_view(lv, n)
    return win @ levels / (9.0 * n)


def _test_vector(sync_levels: np.ndarray) -> dict:
    from dsdneo_tpu.fec.device import imbe_ecc_batch
    from dsdneo_tpu.protocol.p25 import encode as E

    ldus = E.random_voice_ldus(TV_N_LDUS, seed=TV_LDU_SEED)  # [16, 9, 144]
    frames = [E.ldu_frame(TV_NAC, ldus[i], duid=5 if i % 2 == 0 else 10,
                          seed=100 + i) for i in range(TV_N_LDUS)]
    starts = np.cumsum([0] + [len(f) for f in frames[:-1]]).astype(np.int64)
    body = np.concatenate(frames)
    bits88, errs = imbe_ecc_batch(ldus.reshape(-1, 144))
    bits88 = np.asarray(bits88).astype(np.uint8)
    if int(np.asarray(errs).max()) != 0:
        raise RuntimeError("clean test-vector frames decode with errors")

    # no false sync where the picker could act on one, at any cut of the
    # lead: every window that starts in the lead or the tail, and the 32
    # positions before each true sync (a hit there would make the greedy
    # peak walk jump over it).  Hits deeper inside an LDU fall within the
    # accepted frame's extent and are skipped, as on any real stream.
    watch = np.zeros(TV_LEAD + len(body) + TV_TAIL, dtype=bool)
    watch[:TV_LEAD] = True
    watch[TV_LEAD + len(body) - 24:] = True
    for s in TV_LEAD + starts:
        watch[max(s - 32, 0):s] = True
    for fseed in range(TV_FILLER_SEED, TV_FILLER_SEED + 64):
        rng = np.random.default_rng(fseed)
        lead = rng.integers(0, 4, TV_LEAD).astype(np.uint8)
        tail = rng.integers(0, 4, TV_TAIL).astype(np.uint8)
        full = np.concatenate([lead, body, tail])
        peak = np.max([np.abs(_sync_corr(full, lv)) for lv in sync_levels],
                      axis=0)
        peak = np.where(watch[:len(peak)], peak, 0.0)
        if peak.max() < TV_FALSE_SYNC_MAX:
            break
    else:
        raise RuntimeError("no filler seed keeps false syncs below margin")
    return {
        "tv_body": body, "tv_lead": lead, "tv_tail": tail,
        "tv_ldu_starts": starts, "tv_bits88": bits88,
        "tv_seeds": np.array([TV_LDU_SEED, fseed, TV_NAC], np.int64),
        "tv_false_sync_max": np.float32(peak.max()),
    }


def build_tables() -> dict[str, np.ndarray]:
    """Every constant of the port's P25p1 voice path, as numpy arrays."""
    from dsdneo_tpu.dsp import firdes
    from dsdneo_tpu.engine.modes import MODES
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu.fec.device import _imbe_consts, blockcodes_h15_codebook
    from dsdneo_tpu.symbols import framesync
    from dsdneo_tpu.vocoder import glue, imbe, mbe
    from dsdneo_tpu.vocoder.device import _stacked_tables

    mode = MODES["p25p1"]
    names = BatchedP25VoicePipeline.SYNC_NAMES
    defs = [d for d in framesync.SYNC_DEFS if d.name in names]
    sync_levels = np.stack([d.levels for d in defs]).astype(np.float32)
    gather, pn, seed_of_msg, param_g, param_h, g23 = _imbe_consts()
    POS, W, STEPS, OFFS, A = _stacked_tables()

    t = {
        "taps": firdes.channel_lpf(48000.0, mode.lpf_profile
                                   ).astype(np.float32),
        "symbol_rate": np.float64(mode.symbol_rate),
        "four_level": np.bool_(mode.four_level),
        "sync_levels": sync_levels,
        "sync_inverted": np.array([d.inverted for d in defs]),
        "ecc_gather": gather.astype(np.int64),
        "ecc_pn": pn.astype(np.uint8),
        "ecc_seed_of_msg": seed_of_msg.astype(np.int64),
        "ecc_param_g": param_g.astype(np.uint8),
        "ecc_param_h": param_h.astype(np.uint8),
        "golay_codebook": g23.codebook.astype(np.uint8),
        "h15_codebook": blockcodes_h15_codebook().astype(np.uint8),
        "dq_pos": POS.astype(np.int64),
        "dq_w": W.astype(np.float32),
        "dq_steps": STEPS.astype(np.float32),
        "dq_offs": OFFS.astype(np.float32),
        "dq_a": A.astype(np.float32),
        "gain_pos": np.array(imbe.GAIN_POS, np.int64),
        "b0_hi_pos": np.array(imbe.B0_HI_POS, np.int64),
        "b0_lo_pos": np.array(imbe.B0_LO_POS, np.int64),
        "voicing_start": np.int64(imbe.VOICING_START),
        "gain_min": np.float64(imbe.GAIN_MIN),
        "gain_step": np.float64(imbe.GAIN_STEP),
        "pred_decay": np.float64(imbe.PRED_DECAY),
        "imbe_amp_scale": np.float64(mbe._IMBE_AMP_SCALE),
        "tone_b0_min": np.int64(glue.IMBE_TONE_B0_MIN),
        "tone_b0_max": np.int64(glue.IMBE_TONE_B0_MAX),
    }
    t.update(_wire_synth_tables())
    t.update(_test_vector(sync_levels))
    return t


def _wire_synth_tables() -> dict[str, np.ndarray]:
    """What every voice path shares after the vocoder parameters: the
    IMA ADPCM tables and the synthesis noise grid (the f32 casts of the
    f64 grid, which is what the JAX synth uses)."""
    from dsdneo_tpu.ops import audio_wire
    from dsdneo_tpu.vocoder import synth
    return {
        "adpcm_step": audio_wire.STEP_TABLE.astype(np.int32),
        "adpcm_index": audio_wire.INDEX_TABLE.astype(np.int32),
        "synth_bin_w": synth._BIN_W.astype(np.float32),
        "synth_bin_cos": synth._BIN_COS.astype(np.float32),
        "synth_bin_sin": synth._BIN_SIN.astype(np.float32),
    }


def build_dmr_tables() -> dict[str, np.ndarray]:
    """Every constant of the port's DMR voice path and AMBE core, as
    numpy arrays."""
    from dsdneo_tpu.dsp import firdes
    from dsdneo_tpu.engine.dmrbatch import (BatchedDmrVoicePipeline,
                                            synth_voice_stream)
    from dsdneo_tpu.engine.modes import MODES
    from dsdneo_tpu.fec import blockcodes
    from dsdneo_tpu.fec.device import _ambe_consts
    from dsdneo_tpu.symbols import framesync
    from dsdneo_tpu.vocoder.device import _ambe_tables

    mode = MODES["dmr"]
    names = BatchedDmrVoicePipeline.SYNC_NAMES
    defs = [d for d in framesync.SYNC_DEFS if d.name in names]
    gather, g23, pn_of_msg, parity_of_msg, param_of_msg = _ambe_consts()
    W, Cc, ASSIGNED = _ambe_tables()
    _iq, dibits, bits49 = synth_voice_stream(
        n_superframes=DMR_TV_SUPERFRAMES, seed=DMR_TV_SEED)
    t = {
        "taps": firdes.channel_lpf(48000.0, mode.lpf_profile
                                   ).astype(np.float32),
        "symbol_rate": np.float64(mode.symbol_rate),
        "four_level": np.bool_(mode.four_level),
        "sync_levels": np.stack([d.levels for d in defs]
                                ).astype(np.float32),
        "sync_inverted": np.array([d.inverted for d in defs]),
        "ambe_gather": gather.astype(np.int64),
        "ambe_pn": pn_of_msg.astype(np.uint8),
        "ambe_parity": parity_of_msg.astype(np.uint8),
        "ambe_param": param_of_msg.astype(np.uint8),
        "golay_codebook": g23.codebook.astype(np.uint8),
        "qr_codebook": blockcodes.qr_16_7_6().codebook.astype(np.uint8),
        "ambe_w": W.astype(np.float32),
        "ambe_c": Cc.astype(np.float32),
        "ambe_assigned": ASSIGNED.astype(np.float32),
        "tv_dibits": dibits.astype(np.uint8),
        "tv_bits49": bits49.astype(np.uint8),
        "tv_seeds": np.array([DMR_TV_SUPERFRAMES, DMR_TV_SEED], np.int64),
    }
    t.update(_wire_synth_tables())
    return t


def synth_nxdn_voice_stream(n_frames: int = NXDN_TV_FRAMES,
                            seed: int = NXDN_TV_SEED,
                            tail: int = NXDN_TV_TAIL):
    """NXDN full-voice stream from the decoder's own tables, frames of
    192 dibits back to back: the ``+NXDN FSW``, then the 182-dibit
    payload with the LICH 0x36 (parity bit set, one bit per dibit in
    the high bit), random SACCH dibits, and four AMBE frames
    (``encode_ambe_ecc``) at payload dibits 38 + 36k, the payload
    PN9-scrambled (the high bit flipped at the scramble positions).
    Ends in ``tail`` zero dibits.  Returns (dibits, bits49
    ``[4 · n_frames, 49]``)."""
    from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc
    from dsdneo_tpu.protocol.nxdn.decoder import _pn9_scramble_positions
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    rng = np.random.default_rng(seed)
    fsw = next(d for d in SYNC_DEFS if d.name == "+NXDN FSW")
    fsw_d = np.array([int(c) for c in fsw.pattern], dtype=np.uint8)
    scram = np.zeros(182, dtype=np.uint8)
    scram[_pn9_scramble_positions()] = 1
    lich_full = NXDN_FULL_VOICE_LICH << 1
    parity = 0
    for k in range(7, 3, -1):
        parity ^= (lich_full >> k) & 1
    lich_full |= parity
    frames = []
    bits49 = np.zeros((4 * n_frames, 49), dtype=np.uint8)
    for f in range(n_frames):
        payload = np.zeros(182, dtype=np.uint8)
        for i in range(8):
            payload[i] = ((lich_full >> (7 - i)) & 1) << 1
        payload[8:38] = rng.integers(0, 4, 30)
        for k in range(4):
            b = rng.integers(0, 2, 49).astype(np.uint8)
            bits49[4 * f + k] = b
            v = encode_ambe_ecc(b)
            payload[38 + 36 * k:74 + 36 * k] = (v[0::2] << 1) | v[1::2]
        payload ^= scram * 2
        frames.append(np.concatenate([fsw_d, payload]))
    frames.append(np.zeros(tail, dtype=np.uint8))
    return np.concatenate(frames), bits49


def build_tdma_tables() -> dict[str, np.ndarray]:
    """The front ends, host tables and test vectors of the port's
    X2-TDMA, P25 Phase 2 and NXDN voice paths, as numpy arrays."""
    from dsdneo_tpu.dsp import firdes
    from dsdneo_tpu.engine.modes import MODES
    from dsdneo_tpu.engine.nxdnbatch import BatchedNxdnVoicePipeline
    from dsdneo_tpu.engine.p2batch import (BatchedP2VoicePipeline,
                                           synth_p2_voice_stream)
    from dsdneo_tpu.engine.x2batch import (BatchedX2VoicePipeline,
                                           synth_x2_voice_stream)
    from dsdneo_tpu.fec.rs import rs_24_12_13
    from dsdneo_tpu.protocol.nxdn.decoder import _pn9_scramble_positions
    from dsdneo_tpu.symbols import framesync

    t = {f"taps_{p}": firdes.channel_lpf(48000.0, p).astype(np.float32)
         for p in ("12k5", "p25_c4fm", "6k25")}
    for m in ("x2tdma", "p25p2", "nxdn48", "nxdn96"):
        t[f"rate_{m}"] = np.float64(MODES[m].symbol_rate)
    for group, names in (("x2tdma", BatchedX2VoicePipeline.SYNC_NAMES),
                         ("p25p2", BatchedP2VoicePipeline.SYNC_NAMES),
                         ("nxdn", BatchedNxdnVoicePipeline.SYNC_NAMES)):
        defs = [d for d in framesync.SYNC_DEFS if d.name in names]
        t[f"sync_{group}"] = np.stack([d.levels for d in defs]
                                      ).astype(np.float32)
        t[f"sync_{group}_inverted"] = np.array([d.inverted for d in defs])
    f = rs_24_12_13().f
    t["gf64_exp"] = f.exp_table.astype(np.int32)
    t["gf64_log"] = f.log_table.astype(np.int32)
    t["p2_duid_lut"] = BatchedP2VoicePipeline._duid_lut().astype(np.int8)
    keys, vals = BatchedP2VoicePipeline._isch_arrays()
    t["p2_isch_keys"] = keys.astype(np.int64)
    t["p2_isch_vals"] = vals.astype(np.int64)
    t["nxdn_pn9_positions"] = _pn9_scramble_positions().astype(np.int64)

    _iq, dib, bits49 = synth_x2_voice_stream(n_superframes=X2_TV[0],
                                             seed=X2_TV[1])
    t.update(x2_tv_dibits=dib.astype(np.uint8),
             x2_tv_bits49=bits49.astype(np.uint8),
             x2_tv_seeds=np.array(X2_TV, np.int64))
    _iq, dib, bits49 = synth_p2_voice_stream(n_superframes=P2_TV[0],
                                             seed=P2_TV[1])
    t.update(p2_tv_dibits=dib.astype(np.uint8),
             p2_tv_bits49=bits49.astype(np.uint8),
             p2_tv_seeds=np.array(P2_TV, np.int64))
    n_sf, seed, alg, kid, key, mi = P2_ADP_TV
    _iq, dib, bits49 = synth_p2_voice_stream(
        n_superframes=n_sf, seed=seed, alg=alg, kid=kid, key=key, mi=mi)
    t.update(p2_tv_adp_dibits=dib.astype(np.uint8),
             p2_tv_adp_bits49=bits49.astype(np.uint8),
             p2_tv_adp_params=np.array(P2_ADP_TV, np.uint64))
    dib, bits49 = synth_nxdn_voice_stream()
    t.update(nxdn_tv_dibits=dib, nxdn_tv_bits49=bits49,
             nxdn_tv_seeds=np.array([NXDN_TV_FRAMES, NXDN_TV_SEED,
                                     NXDN_TV_TAIL], np.int64))
    return t


def _tsbk(opcode: int, args, mfid: int = 0, lb: bool = False,
          protect: bool = False) -> np.ndarray:
    """One 12-byte TSBK with the protect bit where asked and CRC16 (xor
    0xFFFF), as protocol.p25.encode.tsbk_bytes builds it."""
    from dsdneo_tpu.fec import crc
    b = np.zeros(12, dtype=np.uint8)
    b[0] = (0x80 if lb else 0) | (0x40 if protect else 0) | (opcode & 0x3F)
    b[1] = mfid & 0xFF
    b[2:10] = np.asarray(args, dtype=np.uint8)
    v = crc.crc16_bits(np.unpackbits(b[:10]), init=0, xorout=0xFFFF)
    b[10], b[11] = (v >> 8) & 0xFF, v & 0xFF
    return b


# (mfid, opcode) → byte offsets of the 16-bit channel fields the TSBK
# catalog resolves through the iden table
_TSBK_CHANNELS = {
    (0, 0x00): (3,), (0, 0x02): (2, 6), (0, 0x03): (4,), (0, 0x04): (2,),
    (0, 0x05): (2,), (0, 0x08): (3,), (0, 0x09): (3,), (0, 0x10): (2,),
    (0, 0x11): (3,), (0, 0x39): (4, 7), (0, 0x3A): (7,), (0, 0x3B): (7,),
    (0, 0x3C): (7,), (0x90, 0x02): (3,), (0x90, 0x0B): (2,),
    (0x90, 0x03): (2, 6)}
# the opcodes of the P25 vector: outbound (mfid 0), Motorola (0x90),
# Harris (0xA4), and protected inbound requests
_TSBK_MIX = ([(0, op, False) for op in (
    0x00, 0x02, 0x03, 0x04, 0x05, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x16,
    0x18, 0x1A, 0x1C, 0x1F, 0x20, 0x21, 0x24, 0x27, 0x28, 0x2A, 0x2C, 0x30,
    0x35, 0x39, 0x3A, 0x3B, 0x3C)]
    + [(0x90, op, False) for op in (0x02, 0x03, 0x05, 0x08, 0x09, 0x0A,
                                    0x0B, 0x16)]
    + [(0xA4, 0x30, False)]
    + [(0, op, True) for op in (0x00, 0x04, 0x12, 0x18, 0x28, 0x2C)])


def _random_tsbk(rng, lb: bool) -> np.ndarray:
    """A TSBK of the vector's mix with random arguments; every channel
    field names iden 1 or 2, which the stream's first TSDU defines."""
    mfid, op, protect = _TSBK_MIX[int(rng.integers(len(_TSBK_MIX)))]
    args = rng.integers(0, 256, 8).astype(np.uint8)
    if not protect:
        for off in _TSBK_CHANNELS.get((mfid, op), ()):
            ch = (int(rng.integers(1, 3)) << 12) | int(rng.integers(1, 4096))
            args[off - 2], args[off - 1] = ch >> 8, ch & 0xFF
    return _tsbk(op, args, mfid=mfid, lb=lb, protect=protect)


def _two_pass_lines(parse, n_blocks: int):
    """Run ``parse(i, ctx)`` (which returns the lines and fields of block
    ``i``) over every block twice in one context; the two passes must
    agree.  Returns (lines [L] unicode, block of each line [L], fields
    of each line as repr)."""
    from dsdneo_tpu.protocol.base import DecoderContext
    ctx = DecoderContext()
    passes = []
    for _ in range(2):
        out = []
        for i in range(n_blocks):
            n0 = len(ctx.events)
            parse(i, ctx)
            out.extend((i, e.line, repr(sorted(e.fields.items())))
                       for e in ctx.events[n0:])
        passes.append(out)
    if passes[0] != passes[1]:
        bad = next(a for a, b in zip(*passes) if a != b)
        raise RuntimeError(f"a line of the vector depends on state: {bad}")
    out = passes[0]
    return (np.array([l for _, l, _ in out]),
            np.array([i for i, _, _ in out], dtype=np.int64),
            np.array([f for _, _, f in out]))


def _p25_cc_vector(seed: int = CC_P25_SEED) -> dict[str, np.ndarray]:
    from dsdneo_tpu.protocol.p25 import encode as E
    from dsdneo_tpu.protocol.p25.phase1 import P25P1Decoder
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS, SyncHit
    rng = np.random.default_rng(seed)
    tsdus = [[E.iden_up_tsbk(1, 851.0125e6, 12500.0, 45e6),
              E.iden_up_tdma_tsbk(2, 769.00625e6, 6250.0, 30e6),
              _tsbk(0x3B, [0x11, 0xBE, 0xE0, 0x01, 0x23, 0x11, 0x00, 0x70],
                    lb=True)]]
    frames = [E.tsdu_frame(CC_NAC, tsdus[0])]
    while sum(len(f) for f in frames) < CC_MIN_DIBITS["p25"] + 400:
        t = [_random_tsbk(rng, lb=(k == 2)) for k in range(3)]
        tsdus.append(t)
        frames.append(E.tsdu_frame(CC_NAC, t))
    starts = np.cumsum([0] + [len(f) for f in frames[:-1]]).astype(np.int64)
    payloads = np.stack([p for t in tsdus for p in t]).astype(np.uint8)
    dec = P25P1Decoder()
    sd = next(d for d in SYNC_DEFS if d.name == "+P25p1")

    def parse(i, ctx):
        ctx.state.nac = ctx.state.p2_cc = CC_NAC
        hit = SyncHit(pos=int(starts[i // 3]), score=1.0, sync=sd)
        dec._tsbk(np.unpackbits(payloads[i]), hit, ctx)

    lines, of, fields = _two_pass_lines(parse, len(payloads))
    return {"p25_tv_dibits": np.concatenate(frames).astype(np.uint8),
            "p25_tv_starts": starts, "p25_tv_payloads": payloads,
            "p25_tv_lines": lines, "p25_tv_line_block": of,
            "p25_tv_fields": fields,
            "p25_tv_seeds": np.array([seed, CC_NAC], np.int64)}


def _csbk(op: int, fid: int, data) -> np.ndarray:
    from dsdneo_tpu.protocol.dmr.encode import csbk_bits
    return csbk_bits(op, fid, bytes(int(v) for v in data))


def _dmr_cc_vector(seed: int = CC_DMR_SEED) -> dict[str, np.ndarray]:
    from dsdneo_tpu.engine.ccbatch import BatchedDmrControlPipeline
    from dsdneo_tpu.protocol.dmr import encode as E
    from dsdneo_tpu.protocol.dmr.csbk import decode_csbk
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS, SyncHit
    rng = np.random.default_rng(seed)
    # the opcodes of tests/test_dmr_csbk.py: grants (PV, TV, TD), C_MOVE,
    # C_ALOHA (mfid 0 and Capacity Max), C_AHOY, C_ACKD, P_CLEAR,
    # C_BCAST types 0-3 and 6, preamble, P_MAINT, Cap+ and Con+
    mix = [(48, 0), (49, 0), (52, 0), (57, 0), (25, 0), (25, 0x10),
           (28, 0), (32, 0), (46, 0), (40, 0), (61, 0), (42, 0),
           (0x3B, 0x10), (1, 0x06), (3, 0x06)]
    csbks = []
    n = (CC_MIN_DIBITS["dmr"] - 120 + 143) // 144 + 2
    for k in range(n):
        op, fid = mix[k % len(mix)]
        data = rng.integers(0, 256, 8).astype(np.uint8)
        if op == 49:
            csbks.append(E.tv_grant_csbk(int(rng.integers(1, 4095)),
                                         int(rng.integers(2)),
                                         int(rng.integers(1, 1 << 24)),
                                         int(rng.integers(1, 1 << 24))))
            continue
        if op == 57:
            data[0] = min(int(data[0]), 0xFE)      # LPCN below 0xFFF
        if op == 40:
            data[0] = (int(data[0]) & 0x07) | ([0, 1, 2, 3, 6][k % 5] << 3)
        csbks.append(_csbk(op, fid, data))
    dib = E.cc_stream_dibits(csbks, cc=CC_DMR_COLOR, seed=seed)
    sync = 60 + 144 * np.arange(n, dtype=np.int64) + 12 + 54
    pl = np.packbits(np.stack(csbks), axis=1).astype(np.uint8)
    hit_def = next(d for d in SYNC_DEFS if d.name == "+DMR BS data")
    assert BatchedDmrControlPipeline.SYNC_NAMES[0] == hit_def.name

    def parse(i, ctx):
        hit = SyncHit(pos=int(sync[i]), score=1.0, sync=hit_def)
        detail = decode_csbk(np.unpackbits(pl[i]), ctx, hit=hit, slot=0)
        ctx.emit(f"Sync: +DMR CC | Color Code={CC_DMR_COLOR:02d} | CSBK"
                 f"{detail}", "dmr", hit.pos, cc=CC_DMR_COLOR)

    lines, of, fields = _two_pass_lines(parse, n)
    return {"dmr_tv_dibits": dib.astype(np.uint8), "dmr_tv_starts": sync,
            "dmr_tv_payloads": pl, "dmr_tv_lines": lines,
            "dmr_tv_line_block": of, "dmr_tv_fields": fields,
            "dmr_tv_seeds": np.array([seed, CC_DMR_COLOR], np.int64)}


# message types of the NXDN vector whose lines need no earlier message
# (not the data-call blocks, which continue a header, nor the alias)
_CAC_TYPES = (0x01, 0x04, 0x05, 0x07, 0x08, 0x09, 0x0E, 0x10, 0x11, 0x18,
              0x19, 0x1A, 0x1B, 0x20, 0x24, 0x38)


def cac_bits171(msg147: np.ndarray, ran: int = CC_NXDN_RAN) -> np.ndarray:
    """171 CAC bits: structure 0, RAN, the 147 message bits and the
    CRC16-CAC closed over them (tests/test_ccbatch.py close_crc)."""
    from dsdneo_tpu.protocol.nxdn.decoder import crc16_cac
    bits = np.zeros(171, dtype=np.uint8)
    bits[2:8] = [(ran >> (5 - i)) & 1 for i in range(6)]
    bits[8:155] = msg147
    base = bits.copy()
    r0 = crc16_cac(base)
    A = np.zeros((16, 16), dtype=np.uint8)
    for i in range(16):
        e = base.copy()
        e[155 + i] = 1
        ri = crc16_cac(e) ^ r0
        A[:, i] = [(ri >> (15 - j)) & 1 for j in range(16)]
    b = np.array([(r0 >> (15 - j)) & 1 for j in range(16)], np.uint8)
    M = np.concatenate([A, b[:, None]], axis=1)
    for col in range(16):
        piv = next(r for r in range(col, 16) if M[r, col])
        M[[col, piv]] = M[[piv, col]]
        for r in range(16):
            if r != col and M[r, col]:
                M[r] ^= M[col]
    bits[155:] = M[:, 16]
    assert crc16_cac(bits) == 0
    return bits


def cac_frame_dibits(bits171: np.ndarray, lich: int = 0x01) -> np.ndarray:
    """One 192-dibit RCCH frame: the +NXDN FSW, the LICH (parity set),
    the CAC (K=5 encode, 12:14 puncture, PERM_12_25, two bits per
    dibit), PN9-scrambled (tests/test_ccbatch.py _build_cac_stream)."""
    from dsdneo_tpu.fec import conv
    from dsdneo_tpu.protocol.nxdn.decoder import (_PERM_12_25,
                                                  _pn9_scramble_positions)
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    fsw = next(d for d in SYNC_DEFS if d.name == "+NXDN FSW")
    fsw_d = np.array([int(c) for c in fsw.pattern], dtype=np.uint8)
    scram = np.zeros(182, dtype=np.uint8)
    scram[_pn9_scramble_positions()] = 1
    mapping = [0, 1, 2, None, 3, 4, 5, 6, 7, 8, 9, None, 10, 11]
    lich_full = lich << 1
    parity = 0
    for k in range(7, 3, -1):
        parity ^= (lich_full >> k) & 1
    lich_full |= parity
    enc = conv.encode(bits171)
    deperm = np.zeros(300, dtype=np.uint8)
    for g in range(25):
        for i, m in enumerate(mapping):
            if m is not None:
                deperm[g * 12 + m] = enc[g * 14 + i]
    bits300 = deperm[_PERM_12_25]
    payload = np.zeros(182, dtype=np.uint8)
    for i in range(8):
        payload[i] = ((lich_full >> (7 - i)) & 1) << 1
    payload[8:158] = ((bits300[0::2] << 1) | bits300[1::2]).astype(np.uint8)
    payload ^= scram * 2
    return np.concatenate([fsw_d, payload])


def _nxdn_cc_vector() -> dict[str, np.ndarray]:
    from dsdneo_tpu.protocol.nxdn.decoder import NxdnDecoder
    rng = np.random.default_rng(CC_NXDN_SEED)
    n = -(-CC_MIN_DIBITS["nxdn"] // 192) + 1
    bits = []
    for _ in range(n):
        msg = rng.integers(0, 2, 147).astype(np.uint8)
        t = _CAC_TYPES[int(rng.integers(len(_CAC_TYPES)))]
        msg[2:8] = [(t >> (5 - i)) & 1 for i in range(6)]
        bits.append(cac_bits171(msg))
    dib = np.concatenate([cac_frame_dibits(b) for b in bits])
    starts = 192 * np.arange(n, dtype=np.int64)
    pl = np.packbits(np.concatenate(
        [np.stack(bits), np.zeros((n, 5), np.uint8)], axis=1), axis=1)
    dec = NxdnDecoder()

    def parse(i, ctx):
        ctx.mode_name = "nxdn48"
        b = bits[i]
        ran = 0
        for v in b[2:8]:
            ran = (ran << 1) | int(v)
        ctx.state.nxdn_ran = ran
        detail = dec._message(b[8:155], ctx)
        ctx.emit(f"Sync: NXDN CC  RCCH CAC RAN {ran:02d}{detail}", "nxdn",
                 int(starts[i]), ran=ran)

    lines, of, fields = _two_pass_lines(parse, n)
    return {"nxdn_tv_dibits": dib.astype(np.uint8), "nxdn_tv_starts": starts,
            "nxdn_tv_payloads": pl.astype(np.uint8), "nxdn_tv_lines": lines,
            "nxdn_tv_line_block": of, "nxdn_tv_fields": fields,
            "nxdn_tv_seeds": np.array([CC_NXDN_SEED, CC_NXDN_RAN], np.int64)}


# the sync patterns each monitor correlates, and the largest score its
# vector may give anywhere off a true sync (P25 and DMR; the monitors
# accept at 0.62) or in a window that starts in the lead filler (all
# three; NXDN accepts at 0.55, its 10-symbol FSW then needs a valid LICH)
CC_SYNC_NAMES = {"p25": ("+P25p1", "-P25p1"),
                 "dmr": ("+DMR BS data", "+DMR BS voice"),
                 "nxdn": ("+NXDN FSW", "-NXDN FSW")}
CC_FALSE_SYNC_MAX = 0.55
CC_LEAD = 96              # lead filler dibits (callers cut a suffix)
CC_LEAD_SEED = 1          # first filler seed tried


def _cc_sync_peaks(kind: str, dibits: np.ndarray) -> np.ndarray:
    """The best score over the monitor's sync patterns at every start."""
    from dsdneo_tpu.symbols import framesync
    return np.max([_sync_corr(dibits, d.levels) for d in framesync.SYNC_DEFS
                   if d.name in CC_SYNC_NAMES[kind]], axis=0)


def _cc_lead(kind: str, stream: np.ndarray) -> tuple[np.ndarray, int]:
    """A random lead filler under which no window that starts in the lead
    scores above ``CC_FALSE_SYNC_MAX``, whatever suffix of it a channel
    takes: (filler, its seed)."""
    for seed in range(CC_LEAD_SEED, CC_LEAD_SEED + 256):
        lead = np.random.default_rng(seed).integers(0, 4, CC_LEAD
                                                    ).astype(np.uint8)
        pk = _cc_sync_peaks(kind, np.concatenate([lead, stream[:64]]))
        if pk[:CC_LEAD].max() < CC_FALSE_SYNC_MAX:
            return lead, seed
    raise RuntimeError(f"no {kind} lead filler keeps false syncs low")


def _check_off_sync(kind: str, t: dict[str, np.ndarray]) -> None:
    pre = kind + "_tv_"
    pk = _cc_sync_peaks(kind, t[pre + "dibits"])
    off = np.ones(len(pk), dtype=bool)
    off[t[pre + "starts"]] = False
    if pk[off].max() >= CC_FALSE_SYNC_MAX:
        raise RuntimeError(f"the {kind} vector scores "
                           f"{pk[off].max():.3f} off its syncs")


def build_cc_tables() -> dict[str, np.ndarray]:
    """The constants and test vectors of the port's control-channel
    monitors (P25 TSBK, DMR CSBK, NXDN CAC), as numpy arrays."""
    from dsdneo_tpu.engine import ccbatch
    from dsdneo_tpu.fec import blockcodes, conv
    from dsdneo_tpu.fec.device import _p25_trellis_consts
    from dsdneo_tpu.symbols import framesync

    deperm, expect, nibbles = _p25_trellis_consts()
    mat_idx, h15, h13 = ccbatch._bptc_consts()
    offs, flips, src_idx, wt, a_bits, tab = ccbatch._cac_consts()
    names = ccbatch.BatchedDmrControlPipeline.SYNC_NAMES
    defs = [next(d for d in framesync.SYNC_DEFS if d.name == n)
            for n in names]
    t = {
        "p25_deperm": deperm.astype(np.int32),
        "p25_expect": expect.astype(np.int32),
        "p25_nibbles": nibbles.astype(np.int32),
        "crc16_contrib80": ccbatch._crc16_contrib(80).astype(np.int32),
        "tsdu_offsets": ccbatch._tsdu_offsets().astype(np.int32),
        "bptc_gather": mat_idx.astype(np.int32),
        "h15_codebook": h15.codebook.astype(np.uint8),
        "h13_codebook": h13.codebook.astype(np.uint8),
        "golay20_codebook": blockcodes.golay_20_8().codebook.astype(np.uint8),
        "dmr_st_offs": ccbatch._ST_OFFS.astype(np.int32),
        "dmr_payload_offs": ccbatch._PAYLOAD_OFFS.astype(np.int32),
        "dmr_cc_sync_levels": np.stack([d.levels for d in defs]
                                       ).astype(np.float32),
        "cac_offs": offs.astype(np.int32),
        "cac_flips": flips.astype(np.uint8),
        "cac_src_idx": src_idx.astype(np.int32),
        "cac_wt": wt.astype(np.float32),
        "cac_a_bits": a_bits.astype(np.int32),
        "cac_crc_tab": tab.astype(np.int32),
        "conv_o1": conv._O1.astype(np.uint8),
        "conv_o2": conv._O2.astype(np.uint8),
    }
    t.update(_p25_cc_vector())
    t.update(_dmr_cc_vector())
    t.update(_nxdn_cc_vector())
    for kind in ("p25", "dmr"):
        _check_off_sync(kind, t)
    for kind in ("p25", "dmr", "nxdn"):
        lead, seed = _cc_lead(kind, t[kind + "_tv_dibits"])
        t[kind + "_tv_lead"] = lead
        t[kind + "_tv_seeds"] = np.append(t[kind + "_tv_seeds"], seed)
    return t


# -- the event pipelines: D-STAR and M17 (event_tables.npz) ------------------
OUT_EVENT = os.path.join(DATA, "event_tables.npz")
EV_DEAD = 4               # dibit value of dead air (zero I/Q when modulated)
EV_LEAD = 96              # dead-air lead dibits (callers cut a suffix)
EV_N_SYM = 14398          # symbols of a 3 s block at 4800 baud, 48 kHz
EV_MIN_DIBITS = EV_N_SYM + EV_LEAD + 2016
DSTAR_SEED = 8
DSTAR_PREAMBLE = 64       # alternating symbols before each header
M17_SEED = 17
EV_CHECK_LEADS = (0, 47, 96)   # channels of the exporter's JAX check
EV_SPS = 10


def _dstar_k3_encode(info: np.ndarray) -> np.ndarray:
    """The rate-1/2 K=3 code of the D-STAR header: the lattice of
    ``protocol.dstar.decoder._V_TRANS`` run forward (state = the last two
    input bits, the newest in bit 0) → the coded pairs (s1, s0)."""
    from dsdneo_tpu.protocol.dstar.decoder import _V_TRANS
    out = np.zeros(2 * len(info), dtype=np.uint8)
    st = 0
    for t, b in enumerate(info.tolist()):
        ns = ((st << 1) | int(b)) & 3
        (pa, a1, a0), (_pb, b1, b0) = _V_TRANS[ns]
        out[2 * t:2 * t + 2] = (a1, a0) if st == pa else (b1, b0)
        st = ns
    return out


def _bits_to_2level(bits: np.ndarray) -> np.ndarray:
    """0/1 bits → 2-level dibits (bit 1 → dibit 3, −3; bit 0 → dibit 1)."""
    return np.where(np.asarray(bits) != 0, 3, 1).astype(np.uint8)


def _pattern_dibits(name: str) -> np.ndarray:
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    pat = next(d.pattern for d in SYNC_DEFS if d.name == name)
    return np.array([1 if ch == "1" else 3 for ch in pat], np.uint8)


def _dstar_header(mycall: str, urcall: str, rpt1: str, rpt2: str,
                  suffix: str) -> np.ndarray:
    """41 RF-header octets: flags, RPT2, RPT1, URCALL, MYCALL, suffix and
    the CRC-16/X25 (its high byte first, as ``header_line`` reads it)."""
    from dsdneo_tpu.protocol.dstar.decoder import crc16_x25
    body = bytes(3) + "".join(f"{c:<{n}}"[:n] for c, n in (
        (rpt2, 8), (rpt1, 8), (urcall, 8), (mycall, 8),
        (suffix, 4))).encode()
    hdr = np.frombuffer(body, dtype=np.uint8)
    crc = crc16_x25(hdr)
    return np.concatenate([hdr, [crc >> 8, crc & 0xFF]]).astype(np.uint8)


def _dstar_header_dibits(hdr: np.ndarray) -> np.ndarray:
    """41 octets → the 660 on-air header dibits: 328 bits least
    significant first and two flush bits, the K=3 code, the 24-stride
    interleave (the inverse of the decoder's gather) and the scramble."""
    from dsdneo_tpu.engine.dstarbatch import _dstar_tables
    from dsdneo_tpu.protocol.dstar.decoder import _viterbi_k3
    scram, inv, _ = _dstar_tables()
    info = np.concatenate([((hdr[:, None] >> np.arange(8)) & 1).reshape(-1),
                           np.zeros(2, np.int64)]).astype(np.uint8)
    coded = _dstar_k3_encode(info)
    if not np.array_equal(_viterbi_k3(coded), info):
        raise RuntimeError("the header code does not decode to its bits")
    onair = np.zeros(660, dtype=np.uint8)
    onair[inv] = coded
    return _bits_to_2level(onair ^ scram)


def _sd_blocks(kind: int, payload: bytes) -> np.ndarray:
    """60 slow-data bytes of 6-byte blocks: ``kind`` (a header byte per
    block; 0x40.. for radio text, counting up) and 5 payload bytes each,
    padded with spaces under 0x66 (null data) blocks."""
    out = []
    for b in range(10):
        chunk = payload[5 * b:5 * b + 5]
        if chunk:
            head = kind + b if kind == 0x40 else kind
            out.append(bytes([head]) + chunk.ljust(5, b" "))
        else:
            out.append(bytes([0x66]) + b"     ")
    return np.frombuffer(b"".join(out), dtype=np.uint8).copy()


def _dstar_superframe(sd: np.ndarray, bits49: np.ndarray) -> np.ndarray:
    """(2016 dibits from the voice sync: 21 AMBE frames, ECC-encoded,
    with the 480 scrambled slow-data bits between them; the frames'
    on-air bits ``[21, 72]``)."""
    from dsdneo_tpu.engine.dstarbatch import _dstar_tables, _voice_offsets
    from dsdneo_tpu.protocol.dstar.ambe2400 import encode_dstar_ambe_ecc
    _, _, sd_scram = _dstar_tables()
    voff, doff = _voice_offsets()
    out = np.zeros(2016, dtype=np.uint8)
    out[:24] = _pattern_dibits("+D-STAR")
    voice = np.stack([encode_dstar_ambe_ecc(b) for b in bits49])
    out[voff] = _bits_to_2level(voice)
    sdb = ((sd[:, None] >> np.arange(8)) & 1).reshape(-1).astype(np.uint8)
    out[doff.reshape(-1)] = _bits_to_2level(sdb ^ sd_scram)
    return out, voice


_DSTAR_CALLS = ("W1AW", "JA1YKX", "DL1ABC", "VK2XYZ", "G4KLX", "K6DSS")
_DSTAR_TEXT = ("CQ CQ FROM {} ", "NET CHECK-IN {}", "{} QRV ON D-STAR",
               "73 DE {} ")
# a DPRS position sentence: its '!' at payload index 30, as the decoder's
# position reader expects
_DSTAR_DPRS = "$$CRCABCD,{:<6}>API510,DSTAR*:!4903.50N/07201.75W>"


def _dstar_vector(preamble: int = DSTAR_PREAMBLE,
                  opening: int = 64) -> dict[str, np.ndarray]:
    """A bursty D-STAR channel: transmissions of ``preamble`` alternating
    symbols (64 bits of 1010 on the air), the RF header, 2-4 voice
    superframes (the first carries the header's copy in its slow data,
    then radio text or a DPRS position) and the end pattern (32
    alternating symbols and 000100110101000), with 600-1500 dibits of
    dead air between them, after ``opening`` dibits of dead air (the
    first symbols of a block are the filter's and the discriminator's
    edge)."""
    rng = np.random.default_rng(DSTAR_SEED)
    parts = [np.full(EV_LEAD + opening, EV_DEAD, np.uint8)]
    pos = EV_LEAD + opening
    hd_starts, hd_octets = [], []
    sf_starts, sf_sd, sf_voice, sf_bits, sf_tx = [], [], [], [], []
    alt = np.array([1, 3] * 16, np.uint8)
    pre = np.resize(alt, preamble)
    eot = np.concatenate([alt, _bits_to_2level(
        [int(ch) for ch in "000100110101000"])])
    tx = 0
    while pos < EV_MIN_DIBITS:
        call = _DSTAR_CALLS[tx % len(_DSTAR_CALLS)]
        hdr = _dstar_header(call, "CQCQCQ", "W1AW   B", "W1AW   G",
                            "ID51")
        parts.append(pre)
        pos += len(pre)
        hd_starts.append(pos)
        hd_octets.append(hdr)
        parts += [_pattern_dibits("+D-STAR HD"), _dstar_header_dibits(hdr)]
        pos += 684
        n_sf = int(rng.integers(2, 5))
        for k in range(n_sf):
            if k == 0:
                sd = _sd_blocks(0x55, hdr.tobytes())
            elif k == 2:
                sd = _sd_blocks(0x35, _DSTAR_DPRS.format(call).encode())
            else:
                text = _DSTAR_TEXT[(tx + k) % len(_DSTAR_TEXT)].format(call)
                sd = _sd_blocks(0x40, f"{text:<20}"[:20].encode())
            bits49 = rng.integers(0, 2, (21, 49)).astype(np.uint8)
            frame, voice = _dstar_superframe(sd, bits49)
            sf_starts.append(pos)
            sf_sd.append(sd)
            sf_voice.append(voice)
            sf_bits.append(bits49)
            sf_tx.append(tx)
            parts.append(frame)
            pos += 2016
        gap = int(rng.integers(600, 1501))
        parts += [eot, np.full(gap, EV_DEAD, np.uint8)]
        pos += len(eot) + gap
        tx += 1
    dib = np.concatenate(parts)
    return {"dstar_tv_dibits": dib[EV_LEAD:], "dstar_tv_lead": dib[:EV_LEAD],
            "dstar_tv_hd_starts": np.asarray(hd_starts, np.int64) - EV_LEAD,
            "dstar_tv_hd_octets": np.stack(hd_octets),
            "dstar_tv_sf_starts": np.asarray(sf_starts, np.int64) - EV_LEAD,
            "dstar_tv_sf_sd": np.stack(sf_sd),
            "dstar_tv_sf_voice": np.stack(sf_voice).astype(np.uint8),
            "dstar_tv_sf_bits49": np.stack(sf_bits),
            "dstar_tv_sf_tx": np.asarray(sf_tx, np.int64),
            "dstar_tv_seeds": np.array([DSTAR_SEED], np.int64)}


_M17_CALLS = (("KF6ABC", "N0CALL"), ("W2FBI", "BROADCAST"),
              ("VE3XYZ", "M17-DE"), ("AB1CD", "ALL"))


def _m17_vector() -> dict[str, np.ndarray]:
    """A bursty M17 channel: stream transmissions of 20-40 frames
    (``encode_stream_transmission``: preamble, LSF, stream frames of
    random Codec2 payloads, EOT and the encoder's own 96 symbols of idle
    carrier), then 400-1200 dibits of dead air."""
    from dsdneo_tpu.protocol.m17.encoder import (build_lsf,
                                                 encode_stream_transmission)
    rng = np.random.default_rng(M17_SEED)
    parts = [np.full(EV_LEAD, EV_DEAD, np.uint8)]
    pos = EV_LEAD
    fr_starts, fr_fn, fr_payload, fr_tx = [], [], [], []
    lsf_starts, lsfs, calls, cans = [], [], [], []
    tx = 0
    while pos < EV_MIN_DIBITS:
        src, dst = _M17_CALLS[tx % len(_M17_CALLS)]
        can = tx % 16
        nf = int(rng.integers(20, 41))
        voice = rng.integers(0, 2, (nf, 128)).astype(np.uint8)
        d = encode_stream_transmission(dst, src, voice, can=can)
        lsf_starts.append(pos + 48)
        lsfs.append(build_lsf(dst, src, can=can, stream=True))
        calls.append((dst, src))
        cans.append(can)
        for i in range(nf):
            fr_starts.append(pos + 248 + 192 * i)
            fr_fn.append(i | (0x8000 if i == nf - 1 else 0))
            fr_payload.append(np.packbits(voice[i]))
            fr_tx.append(tx)
        gap = int(rng.integers(400, 1201))
        parts += [d.astype(np.uint8), np.full(gap, EV_DEAD, np.uint8)]
        pos += len(d) + gap
        tx += 1
    dib = np.concatenate(parts)
    return {"m17_tv_dibits": dib[EV_LEAD:], "m17_tv_lead": dib[:EV_LEAD],
            "m17_tv_fr_starts": np.asarray(fr_starts, np.int64) - EV_LEAD,
            "m17_tv_fr_fn": np.asarray(fr_fn, np.int64),
            "m17_tv_fr_payload": np.stack(fr_payload).astype(np.uint8),
            "m17_tv_fr_tx": np.asarray(fr_tx, np.int64),
            "m17_tv_lsf_starts": np.asarray(lsf_starts, np.int64) - EV_LEAD,
            "m17_tv_lsf": np.stack(lsfs).astype(np.uint8),
            "m17_tv_calls": np.array(calls),
            "m17_tv_can": np.asarray(cans, np.int64),
            "m17_tv_seeds": np.array([M17_SEED], np.int64)}


def _event_check_block(tv: dict[str, np.ndarray], modulate) -> np.ndarray:
    """``[3, 3 s, 2]`` float32 I/Q of the vector after the leads of
    ``EV_CHECK_LEADS`` (suffixes of its dead-air lead), 30 dB noise of
    seeds 100-102 (the port's ``protocol.dmr.encode.vector_block``)."""
    from dsdneo_tpu_torch.protocol.dmr.encode import vector_block
    return vector_block(tv, EV_CHECK_LEADS, 100 + np.arange(3),
                        (EV_N_SYM + 2) * EV_SPS, sps=EV_SPS,
                        modulate=modulate, lead_dibits=tv["lead"])


def _check_dstar(tv: dict[str, np.ndarray]) -> None:
    """The JAX pipeline on the vector, held to it by the port's
    ``protocol.dstar.encode.judge``."""
    import jax.numpy as jnp

    from dsdneo_tpu.engine.dstarbatch import BatchedDstarPipeline
    from dsdneo_tpu_torch.protocol.dstar.encode import fm_iq, judge
    iq = _event_check_block(tv, fm_iq)
    pipe = BatchedDstarPipeline(len(EV_CHECK_LEADS))
    _dib, pat, pos, vq, n_sym = pipe.frontend_sync_device(jnp.asarray(iq))
    ac, at, ak, asc = pipe.pick_frames(pat, pos, vq, n_sym)
    recs = pipe.decode_block_records(jnp.asarray(iq))
    for c, lead in enumerate(EV_CHECK_LEADS):
        judge(tv, lead, n_sym, [(t, k, float(s), r) for (cc, t, k, r), s
                                 in zip(recs, asc) if cc == c])


def _check_m17(tv: dict[str, np.ndarray]) -> None:
    """The JAX pipeline on the vector, held to it by the port's
    ``protocol.m17.encode.judge``: every stream frame the block may take
    passes the LICH gate with the vector's FN and payload bytes, no
    other hit passes it, and every LSF whose six chunks lie in the block
    assembles CRC-valid with the vector's callsigns and CAN."""
    import jax.numpy as jnp

    from dsdneo_tpu.engine.m17batch import (GOLAY_ERR_MAX,
                                            BatchedM17VoicePipeline)
    from dsdneo_tpu_torch.protocol.m17.encode import fm_iq, judge
    iq = _event_check_block(tv, fm_iq)
    pipe = BatchedM17VoicePipeline(len(EV_CHECK_LEADS), monitor=set())
    ac, at, blob = pipe.decode_block_records(jnp.asarray(iq))
    pipe.decode_block_events(jnp.asarray(iq))
    for c, lead in enumerate(EV_CHECK_LEADS):
        judge(tv, lead, EV_N_SYM,
              [(int(t), blob[h]) for h, t in enumerate(at) if ac[h] == c],
              [e.line for e in pipe.ctxs[c].events], GOLAY_ERR_MAX)


def build_event_tables() -> dict[str, np.ndarray]:
    """The constants and test vectors of the port's event pipelines
    (D-STAR, M17), as numpy arrays, each vector held to the JAX
    pipeline."""
    from dsdneo_tpu.fec.blockcodes import golay_24_12
    from dsdneo_tpu.protocol.dstar.ambe2400 import _row_positions, _seed12
    from dsdneo_tpu.protocol.p25.imbe_frame import _pn_bits, golay_23_12
    # the D-STAR AMBE ECC's tables, built as fec.device._dstar_ambe_jit
    # builds them
    g23 = golay_23_12()
    pn = np.zeros((4096, 23), np.uint8)
    parity = np.zeros(4096, np.uint8)
    param = np.zeros((4096, 12), np.uint8)
    for m in range(4096):
        cw = g23.codebook[m]
        pn[m] = _pn_bits(_seed12(cw), 23)[::-1]
        parity[m] = int(cw.sum()) & 1
        param[m] = [(m >> (11 - i)) & 1 for i in range(12)]
    t = {"golay23_codebook": g23.codebook.astype(np.uint8),
         "dstar_ambe_pn": pn, "dstar_ambe_parity": parity,
         "dstar_ambe_param": param,
         "golay24_codebook": golay_24_12().codebook.astype(np.uint8)}
    for i, r in enumerate(_row_positions()):
        t[f"dstar_ambe_r{i}"] = r.astype(np.int32)
    dv = _dstar_vector()
    mv = _m17_vector()
    _check_dstar({k[len("dstar_tv_"):]: v for k, v in dv.items()})
    _check_m17({k[len("m17_tv_"):]: v for k, v in mv.items()})
    t.update(dv)
    t.update(mv)
    return t


# -- the paths behind the gated front end: YSF, dPMR, EDACS (burst_tables.npz)
OUT_BURST = os.path.join(DATA, "burst_tables.npz")
BURST_PREAMBLE = 48       # alternating symbols before each transmission
BURST_POSTAMBLE = 96      # and after it (the end of a burst before dead
                          # air is the timing and level windows' edge)
YSF_SEED = 31
DPMR_SEED = 37
EDACS_SEED = 41
EDACS_ESK = 0xA5          # the ESK mask the stream's third reading uses
# the largest clean correlation allowed where a false hit would take a
# frame's place (the pick's thresholds: YSF 0.5, dPMR and EDACS 0.62)
YSF_FALSE_SYNC_MAX = 0.45
DPMR_FALSE_SYNC_MAX = 0.55
EDACS_FALSE_SYNC_MAX = 0.6
BURST_N_SYM = {"ysf": 14398, "dpmr": 7198, "edacs": 28798}  # 3 s blocks
BURST_SPS = {"ysf": 10, "dpmr": 20, "edacs": 5}
EDACS_CHECK_N_SYM = 9598  # 1 s: JAX's top 96 holds the block's ~33 frames


def _false_sync_max(dib: np.ndarray, starts, stride: int,
                    names: tuple[str, ...]) -> float:
    """The largest clean correlation with the patterns ``names`` at a
    position where a false hit could take a frame's place: every
    position outside (s − 8, s + stride − 8) of each frame start s (a
    hit inside falls within the frame's extent or the 8-position
    shoulder the pick refines over).  Dead air (dibit 4) is level 0."""
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    lv = np.array([1.0, 3.0, -1.0, -3.0, 0.0])[dib]
    corr = None
    for d in SYNC_DEFS:
        if d.name in names:
            n = len(d.levels)
            c = np.lib.stride_tricks.sliding_window_view(lv, n) @ d.levels
            c = c / (9.0 * n)
            corr = c if corr is None else np.maximum(corr, c)
    watch = np.ones(len(corr), dtype=bool)
    for st in starts:
        watch[max(st - 7, 0):st + stride - 8] = False
    return float(corr[watch].max())


def _burst_stream(tx_fn, n_min: int, gap: tuple[int, int], seed: int,
                  stride: int, names: tuple[str, ...], margin: float):
    """Transmissions of ``tx_fn(rng)`` → (dibits, frame starts, frame
    records) between an alternating preamble and postamble, each followed
    by a gap of dead air, until ``n_min`` dibits; a transmission is drawn
    again until no false hit reaches ``margin`` where it could take a
    frame's place."""
    rng = np.random.default_rng(seed)
    pre = np.resize(np.array([1, 3], np.uint8), BURST_PREAMBLE)
    post = np.resize(np.array([1, 3], np.uint8), BURST_POSTAMBLE)
    dead = np.full(EV_LEAD, EV_DEAD, np.uint8)
    parts, starts, recs = [dead], [], []
    pos = EV_LEAD
    while pos < n_min:
        for _ in range(200):
            frames, frecs = tx_fn(rng)
            body = np.concatenate([pre] + frames + [post])
            rel = BURST_PREAMBLE + stride * np.arange(len(frames))
            seg = np.concatenate([dead, body, dead])
            if _false_sync_max(seg, EV_LEAD + rel, stride, names) < margin:
                break
        else:
            raise RuntimeError("no draw keeps false syncs below margin")
        g = int(rng.integers(*gap))
        parts += [body, np.full(g, EV_DEAD, np.uint8)]
        starts += (pos + rel).tolist()
        recs += frecs
        pos += len(body) + g
    return np.concatenate(parts), np.asarray(starts, np.int64), recs


def _ysf_vd2_dibits(bits49: np.ndarray, spare: int) -> np.ndarray:
    """One 49-bit AMBE frame → the 52 dibits of a V/D2 voice block: the
    27 protected bits tripled, the 22 others and one ``spare`` bit,
    whitened by the PN95 mask and interleaved (the inverse of the
    pipeline's gather ``bits = raw[inv] ^ pn``)."""
    from dsdneo_tpu.engine.ysfbatch import _vd2_tables
    _offs, inv, pn = _vd2_tables()
    bits = np.concatenate([np.repeat(bits49[:27], 3), bits49[27:],
                           [spare]]).astype(np.uint8)
    raw = np.zeros(104, np.uint8)
    raw[inv] = bits ^ pn
    return (raw[0::2] << 1) | raw[1::2]


def _ysf_vector() -> dict[str, np.ndarray]:
    """A bursty YSF channel: transmissions of 6-12 V/D2 frames (``+YSF``
    sync, a FICH field of random dibits, five blocks of 20 random data
    dibits and a voice block) after an alternating preamble, with
    400-1200 dibits of dead air between them.  The first frame of each
    transmission and about one in six of the others are data frames
    whose voice blocks are random (they must fail the vote gate)."""
    sync = _pattern_dibits("+YSF")

    def tx(rng):
        frames, recs = [], []
        for k in range(int(rng.integers(6, 13))):
            voice = k > 0 and rng.random() >= 1 / 6
            b49 = rng.integers(0, 2, (5, 49)).astype(np.uint8)
            blocks = []
            for blk in range(5):
                v = (_ysf_vd2_dibits(b49[blk], int(rng.integers(0, 2)))
                     if voice else rng.integers(0, 4, 52).astype(np.uint8))
                blocks += [rng.integers(0, 4, 20).astype(np.uint8), v]
            frames.append(np.concatenate(
                [sync, rng.integers(0, 4, 100).astype(np.uint8)] + blocks))
            recs.append((voice, b49))
        return frames, recs

    dib, starts, recs = _burst_stream(
        tx, BURST_N_SYM["ysf"] + EV_LEAD + 480, (400, 1201), YSF_SEED, 480,
        ("+YSF",), YSF_FALSE_SYNC_MAX)
    return {"ysf_tv_dibits": dib[EV_LEAD:], "ysf_tv_lead": dib[:EV_LEAD],
            "ysf_tv_starts": starts - EV_LEAD,
            "ysf_tv_voice": np.array([v for v, _ in recs], bool),
            "ysf_tv_bits49": np.stack([b for _, b in recs]),
            "ysf_tv_seeds": np.array([YSF_SEED], np.int64)}


def _dpmr_vector() -> dict[str, np.ndarray]:
    """A bursty dPMR channel: transmissions of 3-7 FS2 superframe parts
    (``+dPMR FS2`` sync, random control dibits, two groups of four AMBE
    frames through ``encode_ambe_ecc`` at the pipeline's voice offsets)
    after an alternating preamble, with 300-800 dibits of dead air
    between them."""
    from dsdneo_tpu.engine.dpmrbatch import _voice_offsets
    from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc
    sync = _pattern_dibits("+dPMR FS2")
    offs = _voice_offsets().reshape(8, 36)

    def tx(rng):
        frames, recs = [], []
        for _ in range(int(rng.integers(3, 8))):
            part = rng.integers(0, 4, 384).astype(np.uint8)
            part[:12] = sync
            b49 = rng.integers(0, 2, (8, 49)).astype(np.uint8)
            for f in range(8):
                v = encode_ambe_ecc(b49[f])
                part[offs[f]] = (v[0::2] << 1) | v[1::2]
            frames.append(part)
            recs.append(b49)
        return frames, recs

    dib, starts, recs = _burst_stream(
        tx, BURST_N_SYM["dpmr"] + EV_LEAD + 384, (300, 801), DPMR_SEED,
        384, ("+dPMR FS2", "-dPMR FS2"), DPMR_FALSE_SYNC_MAX)
    return {"dpmr_tv_dibits": dib[EV_LEAD:], "dpmr_tv_lead": dib[:EV_LEAD],
            "dpmr_tv_starts": starts - EV_LEAD,
            "dpmr_tv_bits49": np.stack(recs),
            "dpmr_tv_seeds": np.array([DPMR_SEED], np.int64)}


# (msg1, msg2) pairs of the EDACS stream: standard-mode messages (MT-A
# voice group assignments of each kind, data call, login, MT-B group and
# individual updates, status, MT-D site, adjacency, unit enable, all-call)
# and extended-addressing ones (group calls, I-call, login, all-call,
# system information, extended addressing, adjacent site, status)
_EDACS_MESSAGES = (
    ((0 << 25) | ((77 >> 7) << 18) | (7 << 12) | (1 << 11) | 0x155,
     (77 & 0x7F) << 17),
    ((1 << 25) | ((300 >> 7) << 18) | (3 << 12) | 0x020, (300 & 0x7F) << 17),
    ((2 << 25) | ((1234 >> 7) << 18) | (12 << 12) | (1 << 11) | 0x048,
     (1234 & 0x7F) << 17),
    ((3 << 25) | ((9000 >> 7) << 18) | (29 << 12) | (1 << 11) | 0x3A1,
     (9000 & 0x7F) << 17),
    (5 << 25, 0x0123456), (6 << 25, 0x0654321),
    ((7 << 25) | (3 << 22) | (1 << 20) | (9 << 15) | 0x101, 0),
    ((7 << 25) | (3 << 22) | (11 << 15) | (1 << 14) | 0x2345, 0),
    ((7 << 25) | (0 << 22), 0x0000042),
    ((7 << 25) | (7 << 22) | (0x08 << 17) | (1 << 12) | (3 << 9) | 0x1A, 0),
    ((7 << 25) | (7 << 22) | (0x01 << 17) | (5 << 12) | (2 << 9) | (7 << 4),
     0),
    ((7 << 25) | (7 << 22) | (0x07 << 17) | (1 << 14) | 0x0BEE, 0),
    ((7 << 25) | (7 << 22) | (0x0F << 17), 0),
    ((0x03 << 23) | (4 << 17) | 0x1234, (1 << 21) | 100001),
    ((0x06 << 23) | (6 << 17) | (1 << 16) | 0x0777, (1 << 20) | 424242),
    ((0x01 << 23) | (2 << 17) | 0x0042, 55555),
    ((0x10 << 23) | (1 << 21) | 777777, (8 << 20) | 123456),
    ((0x19 << 23) | 0x0099, 654321),
    ((0x16 << 23) | (10 << 17) | (1 << 16), 31337),
    ((0x1F << 23) | (0x8 << 19) | 0xBEEF, 1),
    ((0x1F << 23) | (0xA << 19) | (0x3 << 12) | (0x15 << 5) | 0x11, 0),
    ((0x1F << 23) | (0x1 << 19) | (2 << 12) | (3 << 8) | 0x42, 0),
    ((0x1F << 23) | (0x4 << 19) | 0x2A, 99999),
)


def _edacs_frame(msg1: int, msg2: int) -> np.ndarray:
    """One control-channel frame: the ``+EDACS`` sync and the two 40-bit
    BCH(40,28) words, each three times with the middle copy complemented
    (``tests/test_fleettrunk_edacs.py``'s layout), as 2-level dibits."""
    from dsdneo_tpu.protocol.edacs.decoder import edacs_bch_encode
    w1, w2 = edacs_bch_encode(msg1), edacs_bch_encode(msg2)
    m = (1 << 40) - 1
    bits = [(w >> (39 - i)) & 1 for w in (w1, ~w1 & m, w1, w2, ~w2 & m, w2)
            for i in range(40)]
    return np.concatenate([_pattern_dibits("+EDACS"), _bits_to_2level(bits)])


def _edacs_lines(msgs) -> tuple[list[str], list[int], list[int]]:
    """The JAX catalogs' event lines of every frame, read as the JAX
    monitor reads a ``+EDACS`` channel in each mode of
    ``protocol.edacs.encode.MODES``: (lines, frame index, mode index)."""
    from dsdneo_tpu.protocol.base import DecoderContext
    from dsdneo_tpu.protocol.edacs.decoder import EdacsDecoder
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS, SyncHit
    from dsdneo_tpu_torch.protocol.edacs.encode import MODES
    sync = next(d for d in SYNC_DEFS if d.name == "+EDACS")
    lines, frame, mode = [], [], []
    for mi, m in enumerate(MODES):
        ctx, dec = DecoderContext(), EdacsDecoder()
        for i, (v1, v2) in enumerate(msgs):
            if m == "esk":
                v1 ^= EDACS_ESK << 20
                v2 ^= EDACS_ESK << 20
            n0 = len(ctx.events)
            hit = SyncHit(pos=0, score=1.0, sync=sync)
            line = (dec._extended if m == "ea" else dec._standard)(
                v1, v2, ctx, hit)
            ctx.emit(f"Sync: +EDACS {line}", "edacs", 0)
            for e in ctx.events[n0:]:
                lines.append(e.line)
                frame.append(i)
                mode.append(mi)
    return lines, frame, mode


def _edacs_vector() -> dict[str, np.ndarray]:
    """A continuous EDACS control channel: frames of two messages drawn
    from ``_EDACS_MESSAGES`` back to back, the lead the tail of one frame
    more; a draw is taken again where a false hit 8 dibits before a sync
    would reach ``EDACS_FALSE_SYNC_MAX``, and none may reach it in the
    lead."""
    rng = np.random.default_rng(EDACS_SEED)
    n = -(-(BURST_N_SYM["edacs"] + EV_LEAD) // 288) + 2
    frames, msgs = [], []
    while len(frames) < n:
        for _ in range(200):
            a, b = rng.integers(0, len(_EDACS_MESSAGES), 2)
            m1, m2 = _EDACS_MESSAGES[a][0], _EDACS_MESSAGES[b][1]
            fr = _edacs_frame(m1, m2)
            seg = np.concatenate(frames[-1:] + [fr, _pattern_dibits(
                "+EDACS")])
            if _false_sync_max(seg, range(0, len(seg), 288), 288,
                               ("+EDACS", "-EDACS")) < EDACS_FALSE_SYNC_MAX:
                break
        else:
            raise RuntimeError("no draw keeps false syncs below margin")
        frames.append(fr)
        msgs.append((m1, m2))
    dib = np.concatenate(frames)
    # the lead is the tail of a frame whose sync a block never holds, so
    # no accepted frame suppresses a false hit there
    if _false_sync_max(dib[288 - EV_LEAD:3 * 288], [EV_LEAD, EV_LEAD + 288],
                       288, ("+EDACS", "-EDACS")) >= EDACS_FALSE_SYNC_MAX:
        raise RuntimeError("a false sync in the lead reaches the margin")
    lines, frame, mode = _edacs_lines(msgs[1:])
    return {"edacs_tv_dibits": dib[288:], "edacs_tv_lead": dib[288 - EV_LEAD:
                                                                 288],
            "edacs_tv_starts": 288 * np.arange(n - 1, dtype=np.int64),
            "edacs_tv_msg1": np.array([m for m, _ in msgs[1:]], np.int64),
            "edacs_tv_msg2": np.array([m for _, m in msgs[1:]], np.int64),
            "edacs_tv_lines": np.array(lines),
            "edacs_tv_line_frame": np.asarray(frame, np.int64),
            "edacs_tv_line_mode": np.asarray(mode, np.int64),
            "edacs_tv_esk": np.int64(EDACS_ESK),
            "edacs_tv_seeds": np.array([EDACS_SEED], np.int64)}


def burst_check_block(kind: str, tv: dict[str, np.ndarray], leads,
                      n_sym: int, invert: bool = False) -> np.ndarray:
    """``[len(leads), (n_sym + 2)·sps, 2]`` float32 I/Q of the vector after
    ``leads`` (suffixes of its lead), 30 dB noise of seeds 100, 101, ...
    (the port's ``protocol.dmr.encode.vector_block`` with the kind's
    modulator)."""
    from dsdneo_tpu_torch.protocol.dmr.encode import vector_block
    from dsdneo_tpu_torch.protocol.dpmr import encode as dpmr_encode
    from dsdneo_tpu_torch.protocol.edacs import encode as edacs_encode
    from dsdneo_tpu_torch.protocol.ysf import encode as ysf_encode
    mod = {"ysf": ysf_encode, "dpmr": dpmr_encode,
           "edacs": edacs_encode}[kind]
    sps = BURST_SPS[kind]
    return vector_block(tv, leads, 100 + np.arange(len(leads)),
                        (n_sym + 2) * sps, sps=sps, modulate=mod.fm_iq,
                        lead_dibits=tv["lead"], invert=invert)


def _check_ysf(tv: dict[str, np.ndarray]) -> np.ndarray:
    """The JAX pipeline on the vector (3 s, the three leads of
    ``EV_CHECK_LEADS``), held to it by the port's
    ``protocol.ysf.encode.judge``; returns the accepted (channel,
    position) rows."""
    import jax.numpy as jnp

    from dsdneo_tpu.engine.ysfbatch import BatchedYsfVoicePipeline
    from dsdneo_tpu_torch.protocol.ysf.encode import judge
    n_sym = BURST_N_SYM["ysf"]
    iq = jnp.asarray(burst_check_block("ysf", tv, EV_CHECK_LEADS, n_sym))
    pipe = BatchedYsfVoicePipeline(len(EV_CHECK_LEADS))
    _d, idx, vq, ns = pipe.frontend_sync_device(iq)
    ac, at, _f, _o = pipe.pick_frames(idx, vq, ns)
    bits, verr = pipe.decode_block_bits49(iq)
    bits, verr = bits.reshape(-1, 5, 49), verr.reshape(-1, 5)
    for c, lead in enumerate(EV_CHECK_LEADS):
        judge(tv, lead, ns, [(int(t), bits[h], verr[h])
                             for h, t in enumerate(at) if ac[h] == c])
    return np.stack([ac, at], axis=1).astype(np.int64)


def _check_dpmr(tv: dict[str, np.ndarray]) -> np.ndarray:
    """The JAX pipeline on the vector (3 s, the three leads, and channel 3
    inverted), held to it by the port's ``protocol.dpmr.encode.judge``
    (the 49 bits through the JAX AMBE ECC of the accepted parts);
    returns the accepted (channel, position, inverted) rows."""
    import jax.numpy as jnp

    from dsdneo_tpu.engine.dpmrbatch import (BatchedDpmrVoicePipeline,
                                             _voice_offsets)
    from dsdneo_tpu.fec.device import ambe_ecc_batch
    from dsdneo_tpu_torch.protocol.dpmr.encode import judge
    n_sym = BURST_N_SYM["dpmr"]
    leads = EV_CHECK_LEADS + (20,)
    iq = np.concatenate([
        burst_check_block("dpmr", tv, EV_CHECK_LEADS, n_sym),
        burst_check_block("dpmr", tv, (20,), n_sym, invert=True)])
    pipe = BatchedDpmrVoicePipeline(len(leads))
    dib, idx, vq, dq, ns = pipe.frontend_sync_device(jnp.asarray(iq))
    ac, at, ai, _f, _o = pipe.pick_parts(idx, vq, dq, ns)
    dib = np.asarray(dib)
    pos = np.clip(at[:, None] + _voice_offsets()[None], 0, ns - 1)
    dd = dib[ac[:, None], pos] ^ (ai[:, None] * 2).astype(np.uint8)
    bits72 = np.stack([(dd >> 1) & 1, dd & 1], -1).reshape(-1, 72)
    b49, errs = (np.asarray(a) for a in ambe_ecc_batch(
        jnp.asarray(bits72.astype(np.uint8))))
    b49, errs = b49.reshape(-1, 8, 49), errs.reshape(-1, 8)
    for c, lead in enumerate(leads):
        judge(tv, lead, ns, [(int(t), int(ai[h]), b49[h], errs[h])
                             for h, t in enumerate(at) if ac[h] == c],
              inverted=c == 3)
    return np.stack([ac, at, ai], axis=1).astype(np.int64)


def _check_edacs(tv: dict[str, np.ndarray]) -> np.ndarray:
    """The JAX monitor on 1 s of the vector (its top 96 holds the block's
    ~33 frames): channels at the three leads read in the three modes
    (standard, EA, ESK: set on each channel's context) and a fourth,
    inverted, in the standard mode, held to the vector's lines by the
    port's ``protocol.edacs.encode.judge``; returns the accepted
    (channel, message start) rows."""
    import jax.numpy as jnp

    from dsdneo_tpu.engine.ccbatch import BatchedEdacsControlPipeline
    from dsdneo_tpu_torch.protocol.edacs.encode import MODES, judge
    n_sym = EDACS_CHECK_N_SYM
    leads = EV_CHECK_LEADS + (20,)
    iq = np.concatenate([
        burst_check_block("edacs", tv, EV_CHECK_LEADS, n_sym),
        burst_check_block("edacs", tv, (20,), n_sym, invert=True)])
    pipe = BatchedEdacsControlPipeline(len(leads))
    modes = MODES + ("standard",)
    for c, m in enumerate(modes):
        pipe.ctxs[c].state.edacs_ea = m == "ea"
        pipe.ctxs[c].state.edacs_esk = EDACS_ESK if m == "esk" else 0
    dib, idx, vq, ns = pipe.frontend_sync_device(jnp.asarray(iq))
    ac, at = pipe.pick_frames(idx, vq, ns)
    pipe.events_from_frontend((dib, idx, vq, ns))
    from dsdneo_tpu.engine.ccbatch import edacs_cc_decode_device
    blob = np.asarray(edacs_cc_decode_device(
        dib, jnp.asarray(ac), jnp.asarray(at)))
    for c, lead in enumerate(leads):
        judge(tv, lead, ns, [(int(t), blob[h]) for h, t in enumerate(at)
                             if ac[h] == c],
              [e.line for e in pipe.ctxs[c].events], modes[c], c == 3)
    return np.stack([ac, at], axis=1).astype(np.int64)


def build_burst_tables() -> dict[str, np.ndarray]:
    """The streams of the port's YSF and dPMR voice pipelines and its
    EDACS monitor, as numpy arrays, each held to the JAX pipeline (its
    accepted frames kept as ``<kind>_tv_jax_frames``)."""
    t = {}
    for kind, build, check in (("ysf", _ysf_vector, _check_ysf),
                               ("dpmr", _dpmr_vector, _check_dpmr),
                               ("edacs", _edacs_vector, _check_edacs)):
        v = build()
        pre = kind + "_tv_"
        v[pre + "jax_frames"] = check({k[len(pre):]: a
                                       for k, a in v.items()})
        t.update(v)
    return t


# -- the serial decode path's streams (serial_tables.npz) ----------------
SERIAL_SECONDS = 60.0     # each stream: 2.88 M samples at 48 kHz
SERIAL_NAC = 0x293
SERIAL_TG = 2501
SERIAL_SRC = 1234567
SERIAL_KEY = 0x0123456789  # the ADP key, in the KeyRing under SERIAL_KID
SERIAL_KID = 0x0042
SERIAL_P25_SEED = 14
SERIAL_PV_SEED = 15
SERIAL_LEAD = 240         # random dibits before the first frame
SERIAL_FALSE_SYNC_MAX = 0.5   # the P25 call (TV_FALSE_SYNC_MAX)
SERIAL_EDACS_RUN = 4      # EDACS frames between ProVoice superframes


def _bits_of(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def _hexwords(bits: np.ndarray) -> np.ndarray:
    b = np.asarray(bits, np.int64).reshape(-1, 6)
    return (b << np.arange(5, -1, -1)).sum(axis=1)


def _dibits_of_bits(bits) -> np.ndarray:
    b = np.asarray(bits, np.uint8)
    return ((b[0::2] << 1) | b[1::2]).astype(np.uint8)


def _p25_frame(duid: int, payload: np.ndarray) -> np.ndarray:
    """Sync, NID and ``payload`` data dibits with the status dibits in
    place (``protocol.p25.encode._with_status``)."""
    from dsdneo_tpu.protocol.p25 import encode as E
    data = np.concatenate([E.nid_dibits(SERIAL_NAC, duid), payload])
    return np.concatenate([E.SYNC_DIBITS,
                           E._with_status(data, start=len(E.SYNC_DIBITS))])


def _p25_ldu(duid: int, frames144: np.ndarray, hex24: np.ndarray,
             lsd: np.ndarray) -> np.ndarray:
    """An LDU1 (``duid`` 5) or LDU2 (10) in ``P25P1Decoder._ldu1`` /
    ``_ldu2`` read order: nine voice frames, four Hamming(10,6,3)
    hexwords after each of frames 1-6, the 16 LSD dibits after frame 7
    (``tests/test_crypto_vendor.py:213-225``)."""
    from dsdneo_tpu.fec import blockcodes
    ham = blockcodes.hamming_10_6_3()
    parts, w = [], 0
    for seg in range(9):
        parts.append(_dibits_of_bits(frames144[seg]))
        if 1 <= seg <= 6:
            for _ in range(4):
                parts.append(_dibits_of_bits(ham.encode(int(hex24[w]))))
                w += 1
        elif seg == 7:
            parts.append(lsd)
    return _p25_frame(duid, np.concatenate(parts))


def _lc_group_voice(tg: int, src: int) -> np.ndarray:
    """The 72-bit Group Voice Channel User LC (LCF 0x00, MFID 0)."""
    return np.concatenate([_bits_of(0, 32), _bits_of(tg, 16),
                           _bits_of(src, 24)])


def _sync_of(name: str) -> np.ndarray:
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    d = next(d for d in SYNC_DEFS if d.name == name)
    return np.array([int(c) for c in d.pattern], np.uint8)


def _frame_ok(prev: np.ndarray, nxt: np.ndarray, names,
              margin: float) -> bool:
    """No clean false sync of ``names`` (either polarity) at the 41
    start positions 48 to 8 before the start of ``nxt`` (a frame whose
    sync follows ``prev``), where a hit could take its place in the
    greedy pick; a hit within 8 positions is refined onto the sync."""
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    seg = np.concatenate([prev[-48:], nxt[:48]])
    for d in SYNC_DEFS:
        if d.name in names:
            if np.abs(_sync_corr(seg, d.levels))[:41].max() >= margin:
                return False
    return True


def _p25_call_vector() -> dict[str, np.ndarray]:
    """A 60 s P25 Phase 1 voice call at 4800 symbols/s: random lead,
    HDU (ALGID 0x80), LDU1/LDU2 superframes carrying the Group Voice
    Channel User LC (RS(24,12,13)) and the encryption sync
    (RS(24,16,9)), superframes k with k % 4 in (1, 2) ADP-keyed (each
    LDU2 announcing the next superframe's ALGID, KEY ID and MI), then a
    TDULC with the same LC and random tail.  The voice frames are
    ``vocoder.imbe.encode_frame`` parameter strings (XORed with the ADP
    keystream where keyed) through ``encode_imbe_ecc``; a superframe or
    lead whose end would put a clean false sync where it could shadow
    the next sync is drawn again."""
    from dsdneo_tpu.crypto.keystream import p25_adp_keystream
    from dsdneo_tpu.fec import blockcodes, rs
    from dsdneo_tpu.protocol.p25.imbe_frame import encode_imbe_ecc
    from dsdneo_tpu.vocoder.imbe import (ImbeParams, encode_frame,
                                         harmonics_for_b0)
    names = ("+P25p1",)
    sync = _sync_of("+P25p1")

    def ok(seg):
        return _frame_ok(seg, sync, names, SERIAL_FALSE_SYNC_MAX)

    rng = np.random.default_rng(SERIAL_P25_SEED)
    n_total = int(SERIAL_SECONDS * 4800)
    lc = _lc_group_voice(SERIAL_TG, SERIAL_SRC)
    lc_hex = rs.rs_24_12_13().encode(_hexwords(lc))

    while True:
        lead = rng.integers(0, 4, SERIAL_LEAD).astype(np.uint8)
        if ok(lead):
            break
    hdu_bits = np.concatenate([_bits_of(0, 72), _bits_of(0, 8),
                               _bits_of(0x80, 8), _bits_of(0, 16),
                               _bits_of(SERIAL_TG, 16)])
    gol = blockcodes.golay_18_6_8()
    hdu_hex = rs.rs_36_20_17().encode(_hexwords(hdu_bits))
    hdu = _p25_frame(0x0, np.concatenate(
        [_dibits_of_bits(gol.encode(int(h))) for h in hdu_hex]))
    tdulc = _p25_frame(0xF, np.concatenate(
        [_dibits_of_bits(blockcodes.golay_24_12().encode(
            (int(lc_hex[2 * w]) << 6) | int(lc_hex[2 * w + 1])))
         for w in range(12)]))
    if not ok(hdu):
        raise RuntimeError("a false sync at the end of the HDU")
    ldu_len = len(_p25_ldu(0x5, np.zeros((9, 144), np.uint8),
                           np.zeros(24, np.int64), np.zeros(16, np.uint8)))
    n_sf = (n_total - len(lead) - len(hdu) - len(tdulc) - 64) // (2 * ldu_len)

    def keyed(k):
        return k % 4 in (1, 2)

    mis = [(int(rng.integers(1, 1 << 62)) << 8) if keyed(k) else 0
           for k in range(n_sf + 1)]
    segs = [lead, hdu]
    pos = len(lead) + len(hdu)
    ldu_pos, ldu_duid, imbe, clear, ldu_keyed, ess = [], [], [], [], [], []
    prev = None
    w0_b0 = 80
    for k in range(n_sf):
        ks = (p25_adp_keystream(SERIAL_KEY, mis[k], 202, drop=267)
              if keyed(k) else np.zeros(202, np.uint8))
        nk = k + 1
        es = np.concatenate([_bits_of(mis[nk], 72),
                             _bits_of(0xAA if keyed(nk) else 0x80, 8),
                             _bits_of(SERIAL_KID if keyed(nk) else 0, 16)])
        es_hex = rs.rs_24_16_9().encode(_hexwords(es))
        while True:
            state = prev
            sf_imbe, sf_clear, sf = [], [], []
            for half, (duid, hexw) in enumerate(((0x5, lc_hex),
                                                 (0xA, es_hex))):
                f144 = np.zeros((9, 144), np.uint8)
                f88 = np.zeros((9, 88), np.uint8)
                for j in range(9):
                    b0 = int(np.clip(w0_b0 + rng.integers(-6, 7), 20, 180))
                    w0, L, K = harmonics_for_b0(b0)
                    p = ImbeParams(b0=b0, w0=w0, L=L, K=K,
                                   voiced_bands=rng.integers(
                                       0, 2, K).astype(np.uint8),
                                   log_m=rng.uniform(1.0, 5.0, size=L),
                                   gain_code=int(rng.integers(20, 50)))
                    f88[j] = encode_frame(p, state)
                    state = p
                    off = 101 * half + 11 * j + (2 if j == 8 else 0)
                    kb = np.unpackbits(ks[off:off + 11])[:88]
                    f144[j] = encode_imbe_ecc(f88[j] ^ kb)
                lsd = rng.integers(0, 4, 16).astype(np.uint8)
                sf.append(_p25_ldu(duid, f144, hexw, lsd))
                sf_imbe.append(f144)
                sf_clear.append(f88)
            if ok(sf[0]) and ok(sf[1]):
                break
        prev = state
        for half in range(2):
            ldu_pos.append(pos)
            ldu_duid.append((0x5, 0xA)[half])
            imbe.append(sf_imbe[half])
            clear.append(sf_clear[half])
            ldu_keyed.append(keyed(k))
            pos += len(sf[half])
        ess.append((0xAA if keyed(nk) else 0x80,
                    SERIAL_KID if keyed(nk) else 0))
        segs += sf
    tdulc_pos = pos
    segs.append(tdulc)
    pos += len(tdulc)
    segs.append(rng.integers(0, 4, n_total - pos).astype(np.uint8))
    dib = np.concatenate(segs)
    assert len(dib) == n_total
    imbe = np.stack(imbe)
    clear = np.stack(clear)
    return {
        "p25_dibits": dib,
        "p25_hdu_pos": np.int64(len(lead)),
        "p25_ldu_pos": np.asarray(ldu_pos, np.int64),
        "p25_ldu_duid": np.asarray(ldu_duid, np.int64),
        "p25_imbe": np.packbits(imbe, axis=-1),
        "p25_clear88": np.packbits(clear, axis=-1),
        "p25_keyed": np.asarray(ldu_keyed, bool),
        "p25_ess": np.asarray(ess, np.int64),
        "p25_tdulc_pos": np.int64(tdulc_pos),
        "p25_ids": np.array([SERIAL_NAC, SERIAL_TG, SERIAL_SRC, SERIAL_KEY,
                             SERIAL_KID, SERIAL_P25_SEED], np.int64),
    }


def _pv_vector() -> dict[str, np.ndarray]:
    """A 60 s EDACS control channel at 9600 symbols/s with ProVoice voice
    superframes: runs of ``SERIAL_EDACS_RUN`` frames of the EDACS
    vector of ``burst_tables.npz`` (its messages in order, cycling)
    between ProVoice superframes (``provoice_stream_dibits``, no lead or
    tail) of four random ``encode_imbe7100_ecc`` frames with a random LID
    and BF; a superframe whose end would put a clean false sync where it
    could shadow the next sync is drawn again, a run is longer where its
    last frame would do so before the ProVoice sync, and the stream is
    cut to 60 s."""
    from dsdneo_tpu.protocol.provoice.encode import provoice_stream_dibits
    from dsdneo_tpu.protocol.provoice.imbe7100 import encode_imbe7100_ecc
    ev = _edacs_vector()
    ed_dib, starts = ev["edacs_tv_dibits"], ev["edacs_tv_starts"]
    msg1 = ev["edacs_tv_msg1"]
    names = ("+EDACS", "+ProVoice", "+ProVoice EA")
    pv_sync = _sync_of("+ProVoice")
    rng = np.random.default_rng(SERIAL_PV_SEED)
    n_total = int(SERIAL_SECONDS * 9600)
    segs = [ev["edacs_tv_lead"]]
    pos = len(segs[0])
    e_pos, e_word, p_pos, p_lid, p_bf, p_frames = [], [], [], [], [], []
    i = 0

    def frame(fi):
        return ed_dib[starts[fi]:starts[fi] + 288]

    while pos < n_total:
        run = 0
        # a run ends where the frame's end keeps the ProVoice sync clear
        while run < SERIAL_EDACS_RUN or not _frame_ok(
                segs[-1], pv_sync, names, EDACS_FALSE_SYNC_MAX):
            fi = i % len(starts)
            e_pos.append(pos)
            e_word.append(int(msg1[fi]))
            segs.append(frame(fi))
            pos += 288
            i += 1
            run += 1
        nxt = frame(i % len(starts))
        while True:
            fr = np.stack([encode_imbe7100_ecc(
                rng.integers(0, 2, 90).astype(np.uint8)) for _ in range(4)])
            lid, bf = (int(v) for v in rng.integers(0, 1 << 16, 2))
            seg = provoice_stream_dibits(fr, lid=lid, bf=bf, lead=0, tail=0)
            if _frame_ok(seg, nxt, names, EDACS_FALSE_SYNC_MAX):
                break
        p_pos.append(pos)
        p_lid.append(lid)
        p_bf.append(bf)
        p_frames.append(fr)
        segs.append(seg)
        pos += len(seg)
    dib = np.concatenate(segs)[:n_total]
    # only whole frames count
    e_keep = np.asarray(e_pos) + 288 <= n_total
    p_keep = np.asarray(p_pos) + 768 <= n_total
    return {
        "pv_dibits": dib,
        "pv_edacs_pos": np.asarray(e_pos, np.int64)[e_keep],
        "pv_edacs_word": np.asarray(e_word, np.int64)[e_keep],
        "pv_pos": np.asarray(p_pos, np.int64)[p_keep],
        "pv_lid": np.asarray(p_lid, np.int64)[p_keep],
        "pv_bf": np.asarray(p_bf, np.int64)[p_keep],
        "pv_frames": np.packbits(np.stack(p_frames)[p_keep], axis=-1),
        "pv_seeds": np.array([SERIAL_PV_SEED, SERIAL_EDACS_RUN], np.int64),
    }


# -- the DMR BS and X2-TDMA serial streams ---------------------------------
SERIAL_DMR_SEED = 16
SERIAL_DMR_TOTAL = int(SERIAL_SECONDS * 4800)
SERIAL_DMR_CC = 1
SERIAL_DMR_LEAD = 120     # random dibits before the first slot-burst
SERIAL_DMR_KEY = 0x1122334455     # the RC4 key, in the KeyRing under
SERIAL_DMR_KID = 0x05             # SERIAL_DMR_KID
SERIAL_DMR_MI = 0x2468ACE1        # the RC4 call's PI-header MI
SERIAL_DMR_BP = 7                 # the Basic Privacy key ID
SERIAL_DMR_FALSE_SYNC_MAX = 0.55  # |correlation| off the true syncs
SERIAL_X2_SEED = 2                # synth_x2_voice_stream's first seed
SERIAL_X2_CHUNK = 8               # superframes per synth_x2_voice_stream
SERIAL_DMR_ALIAS = "DSD-NEO 15"   # the talker alias of one call
_DMR_BS_DATA = "313333111331131131331131"
_DMR_BS_VOICE = "131111333113313313113313"
# the CSBKs between calls: TV_Grant and C_ALOHA
_DMR_CSBK_OPS = ((49, 0), (25, 0))


def _sync_dibits(pattern: str) -> np.ndarray:
    return np.array([1 if c == "1" else 3 for c in pattern], np.uint8)


def _dmr_lc(flco: int, fid: int, so: int, tg: int, src: int) -> np.ndarray:
    """A 72-bit full LC: PF|R|FLCO, FID, service options, target, source."""
    return np.concatenate([_bits_of(flco & 0x3F, 8), _bits_of(fid, 8),
                           _bits_of(so, 8), _bits_of(tg, 24),
                           _bits_of(src, 24)])


def _dmr_alias_lcs(text: str) -> list[np.ndarray]:
    """The talker alias header (FLCO 4, 7-bit format, 7 characters) and
    block 1 (FLCO 5, 8 more) carrying ``text``."""
    bits = np.concatenate([_bits_of(ord(c), 7) for c in text]
                          + [np.zeros(7 * 15, np.uint8)])
    hdr = np.concatenate([_bits_of(4, 8), _bits_of(0, 8), _bits_of(0, 2),
                          _bits_of(len(text), 5), bits[:49]])
    blk = np.concatenate([_bits_of(5, 8), _bits_of(0, 8), bits[49:105]])
    return [hdr, blk]


def _dmr_full_lc96(lc72: np.ndarray) -> np.ndarray:
    """The voice LC header / terminator payload: the 9 LC octets and the
    RS(12,9) parity under the 0x96 mask (``DmrBsDecoder._vlc_header``)."""
    from dsdneo_tpu.fec import rs
    syms = np.asarray(lc72, np.int64).reshape(9, 8) @ (1 << np.arange(7, -1, -1))
    cw = rs.rs_12_9().encode(syms)
    cw[9:] ^= 0x96
    return np.concatenate([_bits_of(int(v), 8) for v in cw])


def _dmr_emb_lc128(lc72: np.ndarray) -> np.ndarray:
    """72 LC bits + the 5-bit checksum (octet sum mod 31) as the BPTC
    16×8 matrix of the embedded LC, column-major
    (``DmrBsDecoder._embedded_lc`` inverted)."""
    from dsdneo_tpu.fec.blockcodes import hamming_16_11_4
    ham = hamming_16_11_4()
    octs = np.asarray(lc72, np.int64).reshape(9, 8) @ (1 << np.arange(7, -1, -1))
    data = np.concatenate([lc72, _bits_of(int(octs.sum()) % 31, 5)])
    mat = np.zeros((8, 16), np.uint8)
    mat[0, :11], mat[1, :11] = data[0:11], data[11:22]
    for r in range(5):
        mat[2 + r, :10] = data[22 + 10 * r:32 + 10 * r]
        mat[2 + r, 10] = data[72 + r]
    for r in range(7):
        mat[r] = ham.codebook[int(mat[r, :11] @ (1 << np.arange(10, -1, -1)))]
    mat[7] = mat[:7].sum(axis=0) & 1
    return mat.T.reshape(-1)


def _h17(data12: np.ndarray) -> np.ndarray:
    """Hamming(17,12,3) of the CACH short LC (``slc.hamming17123``)."""
    d = np.zeros(17, np.uint8)
    d[:12] = data12
    d[12] = d[0] ^ d[1] ^ d[2] ^ d[3] ^ d[6] ^ d[7] ^ d[9]
    d[13] = d[0] ^ d[1] ^ d[2] ^ d[3] ^ d[4] ^ d[7] ^ d[8] ^ d[10]
    d[14] = d[1] ^ d[2] ^ d[3] ^ d[4] ^ d[5] ^ d[8] ^ d[9] ^ d[11]
    d[15] = d[0] ^ d[1] ^ d[4] ^ d[5] ^ d[7] ^ d[10]
    d[16] = d[0] ^ d[1] ^ d[2] ^ d[5] ^ d[6] ^ d[8] ^ d[11]
    return d


def _slc_fragments(data28: np.ndarray) -> list[np.ndarray]:
    """A 28-bit short LC → its four 17-bit CACH fragments (CRC8, three
    Hamming(17,12,3), the (i·4) mod 67 interleave)."""
    from dsdneo_tpu.protocol.dmr.slc import crc8_dmr
    d36 = np.zeros(36, np.uint8)
    d36[:28] = data28
    d36[28:] = _bits_of(crc8_dmr(d36, 28), 8)
    deint = np.zeros(68, np.uint8)
    for k in range(3):
        deint[17 * k:17 * k + 17] = _h17(d36[12 * k:12 * k + 12])
    raw = np.zeros(68, np.uint8)
    raw[(np.arange(67) * 4) % 67] = deint[:67]
    raw[67] = deint[67]
    return [raw[17 * k:17 * k + 17] for k in range(4)]


def _dmr_data_burst(bits196: np.ndarray, cc: int, dtype: int) -> np.ndarray:
    """196 on-air payload bits → the 132 burst dibits around the BS data
    sync, with the Golay(20,8) slot type."""
    from dsdneo_tpu.fec.blockcodes import golay_20_8
    st = golay_20_8().codebook[((cc & 0xF) << 4) | (dtype & 0xF)]
    pay = _dibits_of_bits(bits196)
    std = _dibits_of_bits(st)
    return np.concatenate([pay[:49], std[:5], _sync_dibits(_DMR_BS_DATA),
                           std[5:], pay[49:]])


def _dmr_voice_burst(frames72: np.ndarray, center48) -> np.ndarray:
    """Three 72-bit AMBE frames around a 24-dibit centre (the voice sync
    or the EMB and an embedded-LC fragment)."""
    v = _dibits_of_bits(np.concatenate(frames72))
    c = (_sync_dibits(_DMR_BS_VOICE) if center48 is None
         else _dibits_of_bits(center48))
    return np.concatenate([v[:54], c, v[54:]])


def _dmr_sync_corr_max(dib: np.ndarray, lo: int, hi: int,
                       skip: list[tuple[int, int]]) -> float:
    """max |correlation| of every DMR sync definition over the window
    starts [lo, hi) outside the ``skip`` ranges."""
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    lo = max(lo, 0)
    seg = dib[lo:hi + 23]
    if len(seg) < 24:
        return 0.0
    keep = np.ones(len(seg) - 23, bool)
    for a, b in skip:
        keep[max(a - lo, 0):max(b - lo, 0)] = False
    if not keep.any():
        return 0.0
    best = 0.0
    for d in SYNC_DEFS:
        if d.protocol == "dmr":
            c = np.abs(_sync_corr(seg, d.levels))[:len(keep)]
            best = max(best, float(c[keep].max()))
    return best


def _dmr_programs(rng) -> tuple[list[list[tuple]], list[dict]]:
    """The two slots' burst programs: per slot a list of burst specs
    (kind, args), and the calls.  Slot 0: grants and ALOHAs, clear group
    calls, the RC4 call last; slot 1: the data call, the UDT, a clear
    call with the talker alias, the Basic Privacy call, clear calls."""
    calls: list[dict] = []
    n_slot = (SERIAL_DMR_TOTAL - SERIAL_DMR_LEAD) // 144 // 2

    def csbks(slot, n):
        return [("csbk", None)] * n            # drawn with the stream

    def call(slot, tg, src, n_sf, cipher=0, alias=False):
        so = 0x40 if cipher else 0x00
        k = len(calls)
        calls.append({"slot": slot, "tg": tg, "src": src, "n_sf": n_sf,
                      "cipher": cipher, "alias": alias})
        lc = _dmr_lc(0, 0, so, tg, src)
        out = [("vlc", lc), ("vlc", lc)]
        if cipher == 2:
            out.append(("pi", 0x21, SERIAL_DMR_KID, SERIAL_DMR_MI))
        emb = [lc] * n_sf
        if alias:
            emb[1:3] = _dmr_alias_lcs(SERIAL_DMR_ALIAS)
        for sf in range(n_sf):
            frags = _dmr_emb_lc128(emb[sf])
            for vc in range(1, 7):
                out.append(("voice", k, sf, vc,
                            frags[32 * (vc - 2):32 * (vc - 1)]
                            if 2 <= vc <= 5 else None))
        out.append(("tlc", lc))
        return out

    def data_call(slot):
        hb = np.zeros(96, np.uint8)
        hb[0] = 1                              # group
        hb[4:8] = _bits_of(3, 4)               # DPF 3: confirmed
        hb[16:40] = _bits_of(100, 24)
        hb[40:64] = _bits_of(200, 24)
        hb[64] = 1                             # final
        hb[65:72] = _bits_of(2, 7)             # 2 blocks follow
        hb[80:96] = _bits_of(crc.crc16_bits(hb[:80], init=0, xorout=0xFFFF)
                             ^ 0xCCCC, 16)
        payload = np.frombuffer(b"Hello DMR data world over trellis 34",
                                np.uint8)[:32].copy()
        sw = payload.copy()
        sw[0::2], sw[1::2] = payload[1::2], payload[0::2]
        cv = crc32_bits(np.unpackbits(sw))
        full = np.concatenate([payload, np.packbits(_bits_of(cv, 32))])
        return [("dhdr", hb), ("r34", full[:18]), ("r34", full[18:])]

    def udt(slot):
        h = np.zeros(96, np.uint8)
        h[12:16] = _bits_of(4, 4)              # ISO8 text
        h[16:40] = _bits_of(5678, 24)
        h[40:64] = _bits_of(1234, 24)
        h[64:69] = _bits_of(10, 5)             # pad nibbles
        h[80:96] = _bits_of(crc.crc16_bits(h[:80], init=0, xorout=0xFFFF)
                            ^ 0xCCCC, 16)
        app = np.zeros(96, np.uint8)
        app[:40] = np.unpackbits(np.frombuffer(b"HELLO", np.uint8))
        app[80:] = _bits_of(crc.crc16_bits(app[:80], init=0,
                                           xorout=0xFFFF), 16)
        return [("dhdr", h), ("r12", app)]

    from dsdneo_tpu.fec import crc
    from dsdneo_tpu.protocol.dmr.data import crc32_bits
    s0 = (csbks(0, 4) + call(0, 101, 1001, 3) + csbks(0, 3))
    s1 = (csbks(1, 1) + data_call(1) + udt(1) + csbks(1, 1)
          + call(1, 201, 2001, 3, alias=True) + csbks(1, 2))
    s1 += call(1, 202, 2002, 4, cipher=1) + csbks(1, 3)
    tg = 0
    while len(s0) < n_slot - 150:
        tg += 1
        s0 += call(0, 110 + tg, 1100 + tg, 3 + tg % 4) + csbks(0, 2 + tg % 3)
    while len(s1) < n_slot - 40:
        tg += 1
        s1 += call(1, 210 + tg, 2100 + tg, 3 + tg % 4) + csbks(1, 2 + tg % 3)
    s0 += call(0, 303, 3003, 5, cipher=2)
    for s in (s0, s1):
        if len(s) > n_slot:
            raise RuntimeError("a slot's program runs past the stream")
        s += [("idle",)] * (n_slot - len(s))
    return [s0, s1], calls


_SLC_SYS_PARMS = np.concatenate([_bits_of(0x2, 4), _bits_of(1, 2),
                                 _bits_of(5, 7), _bits_of(0b01011, 5),
                                 _bits_of(1, 1), _bits_of(123, 9)])
SERIAL_DMR_SLC_EVERY = 400    # slot-bursts between C_SYS_PARMS short LCs


def _dmr_call_vector() -> dict[str, np.ndarray]:
    """A 60 s DMR BS stream at 4800 symbols/s with traffic on both slots
    (``_dmr_programs``): every slot-burst a CACH (TACT with the slot and
    either a single-fragment SLC activity update or, every
    ``SERIAL_DMR_SLC_EVERY`` bursts, the four fragments of a
    C_SYS_PARMS short LC) and a data burst (BPTC(196,96), rate 3/4 or
    rate 1/2 payload, Golay(20,8) slot type, BS data sync) or a voice
    burst (three AMBE+2 frames through ``encode_ambe_ecc``, the BS voice
    sync on VC1, the EMB and an embedded-LC fragment on VC2-VC5).  The
    calls' voice frames are random parameter strings: in the clear, under
    Basic Privacy key ``SERIAL_DMR_BP`` or under RC4 (ALG 0x21, PI
    header, the MI advancing each superframe, the late-entry fragments
    in the first four C3 bits).  The random parts (voice frames, idle
    payloads, grants, the CACH of bursts whose CACH no decoder reads)
    are drawn again until no sync correlation reaches
    ``SERIAL_DMR_FALSE_SYNC_MAX`` off the true syncs, no voice sync
    has a valid slot type under the data hypothesis, and no superframe
    of a call that is not RC4 carries a valid late-entry MI.  The
    expected detail of each data burst comes from the JAX package's own
    ``DmrBsDecoder`` methods."""
    from dsdneo_tpu.crypto.keystream import (dmr_basic_keystream,
                                             rc4_keystream)
    from dsdneo_tpu.fec import crc
    from dsdneo_tpu.fec.blockcodes import (golay_20_8, hamming_7_4,
                                           qr_16_7_6)
    from dsdneo_tpu.fec.bptc import bptc_196_96_encode
    from dsdneo_tpu.fec.trellis34 import encode_r34
    from dsdneo_tpu.protocol.base import DecoderContext
    from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc
    from dsdneo_tpu.protocol.dmr.bs import CACH_INTERLEAVE, DmrBsDecoder
    from dsdneo_tpu.protocol.dmr.late_entry import (late_entry_decode,
                                                    late_entry_encode,
                                                    mi_advance32)
    from dsdneo_tpu.protocol.dmr.slc import SlcAssembler
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS, SyncHit
    rng = np.random.default_rng(SERIAL_DMR_SEED)
    progs, calls = _dmr_programs(rng)
    cc = SERIAL_DMR_CC
    n_b = len(progs[0]) * 2
    total = SERIAL_DMR_TOTAL
    lead, end = SERIAL_DMR_LEAD, SERIAL_DMR_LEAD + 144 * n_b
    dib = rng.integers(0, 4, total).astype(np.uint8)
    bp = dmr_basic_keystream(SERIAL_DMR_BP)
    gol20, h74, qr = golay_20_8(), hamming_7_4(), qr_16_7_6()
    dtypes = {"csbk": 3, "idle": 9, "vlc": 1, "tlc": 2, "pi": 0,
              "dhdr": 6, "r34": 8, "r12": 7}
    specs = [progs[b % 2][b // 2] for b in range(n_b)]
    pos = lead + 66 + 144 * np.arange(n_b)
    voice = np.array([s[0] == "voice" for s in specs])
    synced = np.array([s[0] != "voice" or s[3] == 1 for s in specs])
    rc4ks: dict = {}
    for k, c in enumerate(calls):
        if c["cipher"] == 2:
            mi = SERIAL_DMR_MI
            for sf in range(c["n_sf"]):
                rk = SERIAL_DMR_KEY.to_bytes(5, "big") + mi.to_bytes(4, "big")
                rc4ks[k, sf] = (np.stack([np.unpackbits(rc4_keystream(
                    rk, 7, drop=256 + 7 * i))[:49] for i in range(18)]),
                    late_entry_encode(mi))
                mi = mi_advance32(mi)

    # the CACH of every burst: the slot, and an SLC where a decoder reads
    # it (data bursts and VC1)
    cach_p17: dict = {}
    slc_text = [""] * n_b
    in_call = [False, False]
    pending: list = []
    for b in range(n_b):
        slot, kind = b % 2, specs[b][0]
        if kind in ("vlc", "pi", "voice"):
            in_call[slot] = True
        if synced[b]:
            if b % SERIAL_DMR_SLC_EVERY == 0:
                pending = list(zip((1, 3, 3, 2),
                                   _slc_fragments(_SLC_SYS_PARMS)))
            if pending:
                cach_p17[b] = pending.pop(0)
                if not pending:
                    a = SlcAssembler()
                    for lcss, f in zip((1, 3, 3, 2),
                                       _slc_fragments(_SLC_SYS_PARMS)):
                        slc_text[b] = a.feed(lcss, f) or ""
            else:
                acts = [0x8 if in_call[s] else 0x2 for s in (0, 1)]
                p17 = _h17(np.concatenate([_bits_of(1, 4),
                                           _bits_of(acts[0], 4),
                                           _bits_of(acts[1], 4)]))
                cach_p17[b] = (0, p17)
                slc_text[b] = SlcAssembler().feed(0, p17) or ""
        if kind == "tlc":
            in_call[slot] = False

    def cach(b, lcss, p17):
        c = np.zeros(24, np.uint8)
        c[:7] = h74.codebook[(1 << 3) | ((b % 2) << 2) | lcss]
        c[7:] = p17
        return _dibits_of_bits(c[CACH_INTERLEAVE])

    frames: dict = {}
    payload: dict = {}

    def draw(b: int) -> None:
        """Burst ``b``'s dibits, its random parts drawn afresh."""
        spec, base = specs[b], lead + 144 * b
        kind = spec[0]
        lcss, p17 = cach_p17.get(
            b, (0, rng.integers(0, 2, 17).astype(np.uint8)))
        dib[base:base + 12] = cach(b, lcss, p17)
        if kind == "voice":
            k, sf, vc, frag = spec[1:]
            c = calls[k]
            plain = rng.integers(0, 2, (3, 49)).astype(np.uint8)
            ks = np.zeros((3, 49), np.uint8)
            onair = plain.copy()
            if c["cipher"] == 1:
                onair ^= bp[None, :]
            elif c["cipher"] == 2:
                sks, frg = rc4ks[k, sf]
                for f in range(3):
                    ks[f] = sks[3 * (vc - 1) + f]
                    onair[f] = plain[f] ^ ks[f]
                    onair[f, 35:39] = _bits_of(int(frg[vc][f]), 4)
            f72 = np.stack([encode_ambe_ecc(x) for x in onair])
            center = None
            if vc > 1:
                emb = qr.codebook[(cc << 3) | ((c["cipher"] > 0) << 2)
                                  | {2: 1, 3: 3, 4: 3, 5: 2, 6: 0}[vc]]
                mid = (frag if frag is not None
                       else rng.integers(0, 2, 32).astype(np.uint8))
                center = np.concatenate([emb[:8], mid, emb[8:]])
            frames[b] = (onair, ks, f72)
            burst = _dmr_voice_burst(f72, center)
        else:
            if kind == "idle":
                bits96 = rng.integers(0, 2, 96).astype(np.uint8)
            elif kind == "csbk" and spec[1] is None:
                bits96 = _dmr_csbk(rng, b % 2)
            elif kind in ("vlc", "tlc"):
                bits96 = _dmr_full_lc96(spec[1])
            elif kind == "pi":
                bits96 = np.zeros(96, np.uint8)
                bits96[0:8] = _bits_of(spec[1], 8)
                bits96[16:24] = _bits_of(spec[2], 8)
                bits96[24:56] = _bits_of(spec[3], 32)
                bits96[80:96] = _bits_of(
                    crc.crc16_bits(bits96[:80], init=0, xorout=0xFFFF)
                    ^ 0x6969, 16)
            else:
                bits96 = spec[1]
            if kind == "r34":
                d98 = encode_r34(spec[1])
                on = np.zeros(196, np.uint8)
                on[0::2], on[1::2] = (d98 >> 1) & 1, d98 & 1
            else:
                on = bptc_196_96_encode(bits96)
            payload[b] = (bits96, on)
            burst = _dmr_data_burst(on, cc, dtypes[kind])
        dib[base + 12:base + 144] = burst

    def random_part(b: int) -> bool:
        s = specs[b]
        return (s[0] in ("voice", "idle") or not synced[b]
                or (s[0] == "csbk" and s[1] is None))

    def violations() -> set:
        """The bursts to draw again."""
        redo = set()
        keep = np.ones(total - 23, bool)
        for p in pos[synced]:
            keep[p - 8:p + 24] = False
        worst = np.zeros(total - 23)
        for d in SYNC_DEFS:
            if d.protocol == "dmr":
                worst = np.maximum(worst, np.abs(_sync_corr(dib, d.levels)))
        for t in np.flatnonzero(keep & (worst >= SERIAL_DMR_FALSE_SYNC_MAX)):
            hit = [b for b in range(max((t - lead) // 144, 0),
                                    min((t + 23 - lead) // 144 + 1, n_b))
                   if random_part(b)]
            if t < lead or t + 24 > end:
                hit.append(-1)         # the lead or the tail
            if not hit:
                raise RuntimeError(f"a false sync {worst[t]:.3f} at {t} in "
                                   "fixed bursts")
            redo.update(hit)
        for b in np.flatnonzero(voice & synced):
            # the data hypothesis must reject a voice sync
            st = np.concatenate([dib[pos[b] - 5:pos[b]],
                                 dib[pos[b] + 24:pos[b] + 29]]) ^ 2
            msg, errs = gol20.decode(
                np.stack([(st >> 1) & 1, st & 1], 1).reshape(-1))
            if errs <= 2 and (msg & 0xF) <= 11:
                redo.add(int(b))
        for b in np.flatnonzero(voice):
            k, sf, vc = specs[b][1:4]
            if vc != 6 or calls[k]["cipher"] == 2:
                continue
            le = np.zeros((7, 3), np.uint8)
            for v in range(1, 7):
                for f in range(3):
                    le[v][f] = _bti(frames[b - 2 * (6 - v)][0][f][35:39])
            _mi, crc_ok, golay_ok = late_entry_decode(le)
            if crc_ok and golay_ok:
                redo.add(int(b))
        return redo

    for b in range(n_b):
        draw(b)
    for _round in range(100):
        redo = violations()
        if not redo:
            break
        for b in redo:
            if b < 0:
                dib[:lead] = rng.integers(0, 4, lead)
                dib[end:] = rng.integers(0, 4, total - end)
            else:
                draw(b)
    else:
        raise RuntimeError("no clean DMR stream")

    # the JAX decoder's detail of each data burst, in stream order
    jd, jctx = DmrBsDecoder(), DecoderContext()
    dhit = next(d for d in SYNC_DEFS if d.name == "+DMR BS data")
    b_type, b_call, b_text, b_extra = [], [], [], []
    f_burst, f_onair, f_ks, f_cipher, f_72 = [], [], [], [], []
    for b in range(n_b):
        spec, slot = specs[b], b % 2
        kind = spec[0]
        text = extra = ""
        call_k = -1
        if kind == "voice":
            onair, ks, f72 = frames[b]
            call_k = spec[1]
            for f in range(3):
                f_burst.append(b)
                f_onair.append(onair[f])
                f_ks.append(ks[f])
                f_cipher.append(calls[call_k]["cipher"])
                f_72.append(f72[f])
            b_type.append(16 + spec[3])
        else:
            bits96, on = payload[b]
            hit = SyncHit(pos=int(pos[b]), score=1.0, sync=dhit)
            if kind == "csbk":
                n_ev = len(jctx.events)
                text = jd._csbk(bits96, jctx, hit, slot)
                extra = "\n".join(e.line for e in jctx.events[n_ev:])
            elif kind == "dhdr":
                text = jd._data_header(bits96, slot)
            elif kind == "r34":
                text = jd._r34_block(on, slot)
            elif kind == "r12":
                text = jd._r12_block(bits96, slot)
            elif kind == "pi":
                text = jd._pi_header(bits96, slot)
                call_k = specs[b + 2][1]       # the call's first VC1
            elif kind in ("vlc", "tlc"):
                lc = spec[1]
                tg, src = _bti(lc[24:48]), _bti(lc[48:72])
                text = f" | {kind.upper()} Group TGT={tg} SRC={src}"
                call_k = next(i for i, c in enumerate(calls)
                              if (c["slot"], c["tg"], c["src"])
                              == (slot, tg, src))
            b_type.append(dtypes[kind])
        b_call.append(call_k)
        b_text.append(text)
        b_extra.append(extra)
    call_arr = np.array([[c["slot"], c["tg"], c["src"], c["n_sf"],
                          c["cipher"], c["alias"]] for c in calls], np.int64)
    first = {}
    for i, k in enumerate(b_call):
        if k >= 0:
            first.setdefault(k, i)
    rc4 = next(k for k, c in enumerate(calls) if c["cipher"] == 2)
    bpc = next(k for k, c in enumerate(calls) if c["cipher"] == 1)
    return {
        "dmr_dibits": dib,
        "dmr_burst_pos": pos.astype(np.int64),
        "dmr_burst_type": np.asarray(b_type, np.int64),
        "dmr_burst_call": np.asarray(b_call, np.int64),
        "dmr_burst_text": np.asarray(b_text),
        "dmr_burst_extra": np.asarray(b_extra),
        "dmr_burst_slc": np.asarray([t.strip() for t in slc_text]),
        "dmr_calls": call_arr,
        "dmr_frame_burst": np.asarray(f_burst, np.int64),
        "dmr_frame_cipher": np.asarray(f_cipher, np.int64),
        "dmr_ambe_onair": np.packbits(np.stack(f_onair), axis=-1),
        "dmr_ambe_rc4ks": np.packbits(np.stack(f_ks), axis=-1),
        "dmr_ambe72": np.packbits(np.stack(f_72), axis=-1),
        "dmr_alias": np.asarray(SERIAL_DMR_ALIAS),
        # the RC4 and BP calls' windows start 10 slot-bursts before them
        "dmr_windows": np.array([max(int(pos[first[k]]) - 66 - 1440, 0)
                                 for k in (rc4, bpc)], np.int64),
        "dmr_ids": np.array([SERIAL_DMR_CC, SERIAL_DMR_KEY, SERIAL_DMR_KID,
                             SERIAL_DMR_MI, SERIAL_DMR_BP, SERIAL_DMR_SEED],
                            np.int64),
    }


def _dmr_csbk(rng, slot: int) -> np.ndarray:
    """A random CSBK of ``_DMR_CSBK_OPS``: a TV_Grant on ``slot`` or a
    C_ALOHA with random fields."""
    from dsdneo_tpu.protocol.dmr import encode as E
    op, fid = _DMR_CSBK_OPS[int(rng.integers(len(_DMR_CSBK_OPS)))]
    if op == 49:
        return E.tv_grant_csbk(int(rng.integers(1, 4095)), slot,
                               int(rng.integers(1, 1 << 24)),
                               int(rng.integers(1, 1 << 24)))
    return _csbk(op, fid, rng.integers(0, 256, 8))


def _bti(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _x2_vector() -> dict[str, np.ndarray]:
    """A 60 s X2-TDMA stream at 6000 symbols/s: chunks of
    ``SERIAL_X2_CHUNK`` superframes of the JAX package's
    ``engine.x2batch.synth_x2_voice_stream`` (dense two-slot voice, each
    chunk with its lead and tail), then random dibits to 60 s.  Each
    chunk's seed is the next from ``SERIAL_X2_SEED`` whose chunk puts no
    X2 sync correlation of ``SERIAL_DMR_FALSE_SYNC_MAX`` or more where
    the serial decoder hunts: outside its superframe walks (slot 0's
    superframe, from its VC1 sync to the end of its sixth burst, which
    also covers slot 1's bursts) and the eight positions before a
    sync."""
    from dsdneo_tpu.engine.x2batch import synth_x2_voice_stream
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    n_total = int(SERIAL_SECONDS * 6000)
    defs = [d for d in SYNC_DEFS if d.protocol == "x2tdma"]
    rng = np.random.default_rng(SERIAL_X2_SEED)
    parts, bits, vc1, seeds = [], [], [], []
    n = 0
    seed = SERIAL_X2_SEED

    def clean(dib, lo, hunt):
        worst = max(float(np.abs(_sync_corr(dib[lo:], d.levels))
                          [hunt[lo:len(dib) - 23]].max(initial=0.0))
                    for d in defs)
        return worst < SERIAL_DMR_FALSE_SYNC_MAX

    while True:
        _x, dib, b49 = synth_x2_voice_stream(SERIAL_X2_CHUNK, seed=seed)
        if n + len(dib) > n_total:
            break
        s0 = n + 90 + 66 + 1728 * np.arange(SERIAL_X2_CHUNK)
        cand = np.concatenate(parts + [dib])
        hunt = np.ones(len(cand), bool)
        for p in np.concatenate(vc1 + [s0]):
            hunt[p - 8:p + 5 * 288 + 78] = False
        if clean(cand, max(n - 23, 0), hunt):
            parts.append(dib)
            bits.append(b49)
            vc1.append(s0)
            seeds.append(seed)
            n += len(dib)
        seed += 1
    while True:
        tail = rng.integers(0, 4, n_total - n).astype(np.uint8)
        cand = np.concatenate(parts + [tail])
        hunt = np.ones(len(cand), bool)
        for p in np.concatenate(vc1):
            hunt[p - 8:p + 5 * 288 + 78] = False
        if clean(cand, n - 23, hunt):
            break
    return {"x2_dibits": cand.astype(np.uint8),
            "x2_vc1_pos": np.concatenate(vc1).astype(np.int64),
            "x2_bits49": np.packbits(np.concatenate(bits, axis=1), axis=-1),
            "x2_seeds": np.asarray(seeds, np.int64)}


# -- the NXDN, dPMR, YSF and D-STAR serial streams -------------------------
SERIAL_NXDN_SEED = 21
SERIAL_NXDN_RAN = 13
SERIAL_NXDN_TOTAL = int(SERIAL_SECONDS * 4800)   # 60 s at NXDN96's rate
SERIAL_NXDN_SF = (2, 7)   # SACCH superframes a call (4 frames each)
SERIAL_DPMR_SEED = 22
SERIAL_DPMR_TOTAL = int(SERIAL_SECONDS * 2400)
SERIAL_DPMR_SF = (14, 21)  # superframes a transmission (two parts each)
SERIAL_DPMR_GAP = (200, 401)  # idle dibits after a transmission's end
SERIAL_YSF_SEED = 23
SERIAL_YSF_TOTAL = int(SERIAL_SECONDS * 4800)
SERIAL_DSTAR_SEED = 24
SERIAL_DSTAR_TOTAL = int(SERIAL_SECONDS * 4800)
SERIAL_DSTAR_GAP = (150, 401)  # idle symbols before each transmission
SERIAL_LEAD4 = 240        # random dibits before the first frame
SERIAL_FAMILY_FALSE_SYNC_MAX = 0.55  # where a false hit would count
# D-STAR's syncs open with the alternating bits its preamble and end
# pattern repeat: the end pattern correlates 0.583 with the header sync
SERIAL_DSTAR_FALSE_SYNC_MAX = 0.6
# (source, destination) of the NXDN calls, dPMR (talkgroup, source)
_SERIAL_NXDN_CALLS = ((1001, 40001), (2345, 40002), (777, 301),
                      (65000, 12345))
_SERIAL_DPMR_IDS = ((1234567, 7654321), (3000001, 5000002),
                    (1111111, 2222222))
_SERIAL_DPMR_CC = (5, 48, 14, 9, 57, 17, 42, 60)
NXDN_LICH_VOICE, NXDN_LICH_MIXED, NXDN_LICH_DATA = 0x36, 0x32, 0x20
NXDN_TX_REL, NXDN_VCALL = 0x08, 0x01


def _hunted_fill(rng, segs, protocol: str, margin, after=None,
                 patience=300):
    """Segments for a stretch the serial hunt reads (no frame takes it),
    each ``draw(rng)`` → (dibits, record) drawn again until no clean
    correlation with ``protocol``'s syncs reaches ``margin`` at a window
    that starts in the stretch (7 positions short of a sync in
    ``after``, the dibits that follow it, if any); windows are judged as
    soon as the segments they cover are drawn, and a segment that finds
    no clean draw sends its predecessor (every tenth time, all of them)
    back to be drawn again, ``patience`` times at most.  Returns (the
    stretch's dibits, the segments' records)."""
    defs = _sync_defs(protocol)
    lmax = max(len(d.levels) for d in defs)
    tail = np.zeros(0, np.uint8) if after is None else \
        np.asarray(after[:48], np.uint8)

    def clean(out: np.ndarray, d: np.ndarray, last: bool) -> bool:
        cand = np.concatenate([out, d] + ([tail] if last else []))
        end = len(out) + len(d)
        qhi = end - 7 if (last and after is not None) else end
        qlo = max(len(out) - lmax + 1, 0)
        for sd in defs:
            n = len(sd.levels)
            top = min(qhi, len(cand) - n + 1)
            if top > qlo and np.abs(_sync_corr(cand[qlo:top + n - 1],
                                               sd.levels)).max() >= margin:
                return False
        return True

    done: list = []                   # (dibits, record) drawn so far
    tries = 0
    while len(done) < len(segs):
        k = len(done)
        out = (np.concatenate([d for d, _ in done]) if done
               else np.zeros(0, np.uint8))
        for _ in range(100):
            d, rec = segs[k](rng)
            if clean(out, d, k == len(segs) - 1):
                done.append((d, rec))
                break
        else:
            tries += 1
            if tries > patience:
                raise RuntimeError("no draw keeps the hunted stretch clean")
            # back one segment; every tenth time, from the start
            del done[-1 if tries % 10 else 0:]
    out = np.concatenate([d for d, _ in done]).astype(np.uint8)
    return out, [r for _, r in done]


def _clean_tail(rng, n: int, protocol: str, margin: float) -> np.ndarray:
    """``n`` random dibits after the last frame, drawn clean."""
    return _hunted_fill(rng, _random_chunks(n), protocol, margin)[0]


@functools.lru_cache(maxsize=None)
def _sync_defs(protocol: str) -> tuple:
    """The sync patterns of ``protocol``'s family, both polarities."""
    from dsdneo_tpu.symbols.framesync import SYNC_DEFS
    return tuple(d for d in SYNC_DEFS if d.protocol == protocol)


def _sync_names(protocol: str) -> tuple[str, ...]:
    return tuple(d.name for d in _sync_defs(protocol))


def _random_chunks(n: int, alphabet=(0, 1, 2, 3), chunk: int = 12):
    """Draw functions for ``n`` random dibits of ``alphabet``, ``chunk``
    at a time."""
    a = np.asarray(alphabet, np.uint8)
    sizes = [chunk] * (n // chunk) + ([n % chunk] if n % chunk else [])
    return [lambda rng, k=k: (a[rng.integers(0, len(a), k)], None)
            for k in sizes]


def _ambe_dibits(bits49: np.ndarray) -> np.ndarray:
    from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc
    return _dibits_of_bits(encode_ambe_ecc(bits49))


# -- NXDN
def _nxdn_lich_dibits(lich: int) -> np.ndarray:
    """The LICH's 8 dibits: its bits in the high bit, the parity bit
    closed as ``NxdnDecoder.handle`` checks it."""
    nbits = 7 if lich in (0x08, 0x4A, 0x48, 0x46) else 4
    full = lich << 1
    for k in range(7, 8 - nbits, -1):
        full ^= (full >> k) & 1
    return np.array([((full >> (7 - i)) & 1) << 1 for i in range(8)],
                    np.uint8)


def _nxdn_message(mtype: int, src: int, dst: int, n: int,
                  fill: np.ndarray | None = None) -> np.ndarray:
    """An ``n``-bit NXDN message of the VCALL family: type, CC option 0,
    group call, voice option 0 (4800 bps EHR), source and destination;
    the bits after them ``fill`` (zeros by default)."""
    msg = np.zeros(n, np.uint8)
    msg[2:8] = _bits_of(mtype, 6)
    msg[16:19] = _bits_of(1, 3)
    msg[24:40] = _bits_of(src, 16)
    msg[40:56] = _bits_of(dst, 16)
    if fill is not None:
        msg[56:] = fill
    return msg


def _nxdn_sacch_dibits(part: int, seg18: np.ndarray) -> np.ndarray:
    """SACCH part ``part`` (0-3 of the superframe) with the RAN and 18
    message bits: CRC6, the K=5 code, 2 of each 12 punctured, PERM_12_5
    (the inverse of ``NxdnDecoder._sacch``)."""
    from dsdneo_tpu.fec import conv
    from dsdneo_tpu.protocol.nxdn.decoder import _PERM_12_5, crc6_nxdn
    d = np.concatenate([_bits_of(3 - part, 2),
                        _bits_of(SERIAL_NXDN_RAN, 6), seg18])
    d = np.concatenate([d, _bits_of(crc6_nxdn(d), 6)])
    enc = conv.encode(d)
    kept = enc[[i for i in range(72) if i % 12 not in (5, 11)]]
    return _dibits_of_bits(kept[_PERM_12_5])


def _nxdn_facch_dibits(msg80: np.ndarray) -> np.ndarray:
    """FACCH1: CRC12, the K=5 code, 1 of each 4 punctured, PERM_16_9
    (the inverse of ``NxdnDecoder._facch1``)."""
    from dsdneo_tpu.fec import conv
    from dsdneo_tpu.protocol.nxdn.decoder import _PERM_16_9, crc12_nxdn
    d = np.concatenate([msg80, _bits_of(crc12_nxdn(msg80), 12)])
    enc = conv.encode(d)
    kept = enc[[i for i in range(192) if i % 4 != 1]]
    return _dibits_of_bits(kept[_PERM_16_9])


def _nxdn_frame(lich: int, sacch: np.ndarray, halves) -> np.ndarray:
    """One 192-dibit frame: the ``+NXDN FSW``, the LICH, the SACCH
    dibits and two 72-dibit halves, PN9-scrambled."""
    from dsdneo_tpu.protocol.nxdn.decoder import _SCRAMBLE_POS
    payload = np.concatenate([_nxdn_lich_dibits(lich), sacch] + halves)
    payload[_SCRAMBLE_POS] ^= 2
    return np.concatenate([_sync_of("+NXDN FSW"), payload])


def _nxdn_serial_vector() -> dict[str, np.ndarray]:
    """An NXDN traffic channel, 60 s at NXDN96's 4800 symbols/s (and
    120 s at NXDN48's 2400, of which ``serialvec`` sends the first 60 s):
    a lead, then calls
    back to back, each ``SERIAL_NXDN_SF`` SACCH superframes of four
    frames whose SACCH parts (PF 1/4 to 4/4) carry a VCALL with the
    call's source and destination and the RAN: a data frame (LICH 0x20:
    FACCH1 VCALL in both halves), voice frames (LICH 0x36: four AMBE
    frames), and a mixed frame to close (LICH 0x32: FACCH1 TX_REL, then
    two AMBE frames); random dibits to the end.  A frame whose end would
    put a clean false sync where it could shadow the next frame's sync
    takes new voice bits (or FACCH fill bits), and the lead and the tail
    are drawn clean."""
    names = _sync_names("nxdn")
    margin = SERIAL_FAMILY_FALSE_SYNC_MAX
    rng = np.random.default_rng(SERIAL_NXDN_SEED)
    frames, lich, pf, call, facch, ambe, n_ambe = [], [], [], [], [], [], []
    n_frames = (SERIAL_NXDN_TOTAL - SERIAL_LEAD4) // 192 - 1
    k = 0

    def draw_tail(f):
        """The frame's random part: its last half's voice bits, or the
        fill of its last FACCH1."""
        if f["lich"] == NXDN_LICH_DATA:
            fill = rng.integers(0, 2, 24).astype(np.uint8)
            f["halves"][1] = _nxdn_facch_dibits(_nxdn_message(
                NXDN_VCALL, f["src"], f["dst"], 80, fill))
        else:
            b = rng.integers(0, 2, (2, 49)).astype(np.uint8)
            f["bits"][-2:] = list(b)
            f["halves"][1] = np.concatenate([_ambe_dibits(x) for x in b])
        f["dib"] = _nxdn_frame(f["lich"], f["sacch"], f["halves"])

    while len(frames) < n_frames:
        src, dst = _SERIAL_NXDN_CALLS[k % len(_SERIAL_NXDN_CALLS)]
        n_sf = int(rng.integers(*SERIAL_NXDN_SF))
        vcall = _nxdn_message(NXDN_VCALL, src, dst, 72)
        for i in range(4 * n_sf):
            if len(frames) == n_frames:
                break
            kind = (NXDN_LICH_DATA if i == 0 else NXDN_LICH_MIXED
                    if i == 4 * n_sf - 1 else NXDN_LICH_VOICE)
            f = {"lich": kind, "src": src, "dst": dst, "bits": [],
                 "sacch": _nxdn_sacch_dibits(i % 4,
                                             vcall[18 * (i % 4):
                                                   18 * (i % 4) + 18])}
            if kind == NXDN_LICH_DATA:
                h0 = _nxdn_facch_dibits(_nxdn_message(NXDN_VCALL, src, dst,
                                                      80))
                f["halves"] = [h0, None]
                f["facch"] = (NXDN_VCALL, NXDN_VCALL)
            else:
                if kind == NXDN_LICH_MIXED:
                    h0 = _nxdn_facch_dibits(_nxdn_message(NXDN_TX_REL, src,
                                                          dst, 80))
                    f["facch"] = (NXDN_TX_REL, -1)
                else:
                    b = rng.integers(0, 2, (2, 49)).astype(np.uint8)
                    f["bits"] = list(b)
                    h0 = np.concatenate([_ambe_dibits(x) for x in b])
                    f["facch"] = (-1, -1)
                f["bits"] += [None, None]
                f["halves"] = [h0, None]
            draw_tail(f)
            f["pf"], f["call"] = i % 4, k
            frames.append(f)
        k += 1
    # a frame's tail against the next frame's head
    for a, b in zip(frames, frames[1:]):
        for _ in range(5000):
            if _frame_ok(a["dib"], b["dib"], names, margin):
                break
            draw_tail(a)
        else:
            raise RuntimeError("no NXDN frame tail keeps the sync clear")
    first = frames[0]["dib"]
    lead = _hunted_fill(rng, _random_chunks(SERIAL_LEAD4), "nxdn", margin,
                        after=first)[0]
    body = np.concatenate([lead] + [f["dib"] for f in frames])
    tail = _clean_tail(rng, SERIAL_NXDN_TOTAL - len(body), "nxdn", margin)
    dib = np.concatenate([body, tail]).astype(np.uint8)
    pos = SERIAL_LEAD4 + 192 * np.arange(len(frames), dtype=np.int64)
    bits = np.stack([b for f in frames for b in f["bits"] if b is not None])
    return {"nxdn_dibits": dib,
            "nxdn_frame_pos": pos,
            "nxdn_frame_lich": np.array([f["lich"] for f in frames],
                                        np.int64),
            "nxdn_frame_pf": np.array([f["pf"] for f in frames], np.int64),
            "nxdn_frame_call": np.array([f["call"] for f in frames],
                                        np.int64),
            "nxdn_frame_facch": np.array([f["facch"] for f in frames],
                                         np.int64),
            "nxdn_calls": np.array([_SERIAL_NXDN_CALLS[c % len(
                _SERIAL_NXDN_CALLS)] for c in range(k)], np.int64),
            "nxdn_bits49": np.packbits(bits, axis=-1),
            "nxdn_ids": np.array([SERIAL_NXDN_RAN, SERIAL_NXDN_SEED],
                                 np.int64)}


# -- dPMR
def _dpmr_cch_dibits(fn: int, id12: int, fill: np.ndarray) -> np.ndarray:
    """One 36-dibit CCH: FN, the 12-bit half of an AI ID, ``fill`` (27
    bits: mode, version, format and the rest), CRC7; six Hamming(12,8)
    words, the 6×12 interleave and the scramble (the inverse of
    ``DpmrDecoder._cch``)."""
    from dsdneo_tpu.fec import blockcodes
    from dsdneo_tpu.protocol.dpmr.decoder import (_DEINT_6x12, _SCRAMBLE_72,
                                                  crc7_dpmr)
    d = np.concatenate([_bits_of(fn, 2), _bits_of(id12, 12), fill])
    d = np.concatenate([d, _bits_of(crc7_dpmr(d), 7)])
    ham = blockcodes.hamming_12_8()
    cw = np.concatenate([ham.encode(_bti(d[8 * j:8 * j + 8]))
                         for j in range(6)])
    if not np.array_equal(cw.reshape(6, 12)[:, :8], d.reshape(6, 8)):
        raise RuntimeError("Hamming(12,8) is not data-first")
    out = np.zeros(72, np.uint8)
    out[_DEINT_6x12] = cw
    return _dibits_of_bits(out ^ _SCRAMBLE_72)


def _dpmr_cc_dibits(cc: int) -> np.ndarray:
    """The 12 dibits of colour code ``cc``'s channel code."""
    from dsdneo_tpu.protocol.dpmr.decoder import _CC_MAP
    code = next(k for k, v in _CC_MAP.items() if v == cc)
    return np.array([(code >> (22 - 2 * i)) & 3 for i in range(12)],
                    np.uint8)


def _dpmr_colour(rng, t: int, src: int, margin: float) -> int:
    """Transmission ``t``'s colour code: the first of ``_SERIAL_DPMR_CC``
    from its turn on whose channel code can open a part B of ``src``
    (its CCH1 opening follows the code; some pairs force a false FS2)."""
    for i in range(len(_SERIAL_DPMR_CC)):
        cc = _SERIAL_DPMR_CC[(t + i) % len(_SERIAL_DPMR_CC)]
        try:
            _hunted_fill(rng, [lambda r: (_dpmr_cc_dibits(cc), None),
                               lambda r: (_dpmr_cch_dibits(
                                   2, src >> 12, r.integers(0, 2, 27).astype(
                                       np.uint8)), None)], "dpmr", margin,
                         patience=3)
            return cc
        except RuntimeError:
            continue
    raise RuntimeError(f"no colour code opens a part B of {src}")


def _dpmr_serial_vector() -> dict[str, np.ndarray]:
    """A 60 s dPMR channel at 2400 symbols/s: a lead, then transmissions,
    each a header frame (``+dPMR FS1`` and 168 dibits), ``SERIAL_DPMR_SF``
    voice superframes of two 384-dibit parts, an end frame (``+dPMR
    FS4``) and idle dibits.  Part A opens with ``+dPMR FS2``: CCH1 (FN 0,
    the talkgroup's high 12 bits), four AMBE frames, the colour code's
    channel code, CCH2 (FN 1, the low 12 bits), four AMBE frames.  Part B
    opens with the channel code and carries ``+dPMR FS3`` where part A
    has it, its CCHs the source (FN 2, 3); the hunt finds part B by its
    FS3 (``DpmrDecoder.handle`` steps back one frame).  Every stretch no
    frame takes (the lead, the header, part B's first frame, the end and
    the idle dibits) is drawn clean of false syncs, and a part B whose
    end would shadow the next sync takes new voice bits.  FS4 is FS1
    negated, so an inverted channel takes the same frames (a header as
    an end, an end as a header)."""
    names = _sync_names("dpmr")
    margin = SERIAL_FAMILY_FALSE_SYNC_MAX
    rng = np.random.default_rng(SERIAL_DPMR_SEED)

    def ambe(r):
        b = r.integers(0, 2, 49).astype(np.uint8)
        return _ambe_dibits(b), b

    def cch(fn, id12):
        return lambda r: (_dpmr_cch_dibits(
            fn, id12, r.integers(0, 2, 27).astype(np.uint8)), None)

    segs = []       # dibits, or ("end", length) for an idle stretch
    sync_pos, sync_kind = [], []
    part_pos, part_kind, part_tx, part_bits = [], [], [], []
    tx_ids = []
    pos = 0
    lead = None
    t = 0
    while True:
        tg, src = _SERIAL_DPMR_IDS[t % len(_SERIAL_DPMR_IDS)]
        cc = _dpmr_colour(rng, t, src, margin)
        n_sf = int(rng.integers(*SERIAL_DPMR_SF))
        fs1 = _sync_of("+dPMR FS1")
        need = 192 + 768 * n_sf + 192 + SERIAL_DPMR_GAP[1]
        if pos + (SERIAL_LEAD4 if lead is None else 0) + need > \
                SERIAL_DPMR_TOTAL:
            break
        if lead is None:
            lead, _ = _hunted_fill(rng, _random_chunks(SERIAL_LEAD4),
                                   "dpmr", margin, after=fs1)
            segs.append(lead)
            pos = len(lead)
        sync_pos.append(pos)
        sync_kind.append(1)
        parts = []
        # part A, then part B's opening frame (hunted), then its FS3 frame
        a_head = np.concatenate([_sync_of("+dPMR FS2"),
                                 cch(0, tg >> 12)(rng)[0]])
        header, _ = _hunted_fill(rng, _random_chunks(168), "dpmr", margin,
                                 after=a_head)
        seg_tx = [fs1, header]
        p = pos + 192
        for k in range(n_sf):
            head = a_head if k == 0 else np.concatenate(
                [_sync_of("+dPMR FS2"), cch(0, tg >> 12)(rng)[0]])
            ga = [ambe(rng) for _ in range(4)]
            gb = [ambe(rng) for _ in range(4)]
            part_a = np.concatenate(
                [head] + [d for d, _ in ga] + [_dpmr_cc_dibits(cc),
                                               cch(1, tg & 0xFFF)(rng)[0]]
                + [d for d, _ in gb])
            fs3_head = np.concatenate([_sync_of("+dPMR FS3"),
                                       cch(3, src & 0xFFF)(rng)[0]])
            b1, recs = _hunted_fill(
                rng, [lambda r: (_dpmr_cc_dibits(cc), None),
                      cch(2, src >> 12)] + [ambe] * 4, "dpmr", margin,
                after=fs3_head)
            gd = [ambe(rng) for _ in range(4)]
            part_b = [b1, fs3_head] + [d for d, _ in gd]
            parts.append([part_a, part_b, [b for _, b in ga + gb],
                          recs[2:], gd])
            sync_pos += [p, p + 384 + 192]
            sync_kind += [2, 3]
            part_pos += [p, p + 384]
            part_kind += [2, 3]
            part_tx += [t, t]
            p += 768
        # each part B's end against the next sync (FS2 or FS4)
        fs4 = _sync_of("+dPMR FS4")
        for k, (pa, pb, _ba, _bb, gd) in enumerate(parts):
            nxt = (parts[k + 1][0][:48] if k + 1 < n_sf else fs4)
            for _ in range(5000):
                tail = np.concatenate(pb[:2] + [d for d, _ in gd])
                if _frame_ok(tail, nxt, names, margin):
                    break
                gd[2:] = [ambe(rng), ambe(rng)]
            else:
                raise RuntimeError("no dPMR part B end keeps the sync clear")
            pb[2:] = [d for d, _ in gd]
            part_bits.append(np.stack(_ba))
            part_bits.append(np.stack([b for b in _bb]
                                      + [b for _, b in gd]))
            seg_tx += [pa] + pb
        sync_pos.append(p)
        sync_kind.append(4)
        gap = int(rng.integers(*SERIAL_DPMR_GAP))
        seg_tx.append(fs4)
        segs += seg_tx
        tx_ids.append((tg, src, cc))
        pos = p + 24
        # the end frame's 168 dibits and the idle ones: hunted
        end_len = 168 + gap
        segs.append(("end", end_len))
        pos += end_len
        t += 1
    # fill each end stretch now that what follows it is known: the next
    # transmission's FS1, or for the last, the rest of the 60 s
    fixed = sum(len(g) for g in segs if not isinstance(g, tuple))
    ends = [i for i, g in enumerate(segs) if isinstance(g, tuple)]
    segs[ends[-1]] = ("end", SERIAL_DPMR_TOTAL - fixed - sum(
        segs[i][1] for i in ends[:-1]))
    out = []
    for i, sgm in enumerate(segs):
        if isinstance(sgm, tuple):
            nxt = _sync_of("+dPMR FS1") if i + 1 < len(segs) else None
            sgm, _ = _hunted_fill(rng, _random_chunks(sgm[1]), "dpmr",
                                  margin, after=nxt)
        out.append(sgm)
    dib = np.concatenate(out).astype(np.uint8)
    sync_pos = np.asarray(sync_pos, np.int64)
    sync_kind = np.asarray(sync_kind, np.int64)
    return {"dpmr_dibits": dib,
            "dpmr_sync_pos": sync_pos, "dpmr_sync_kind": sync_kind,
            "dpmr_part_pos": np.asarray(part_pos, np.int64),
            "dpmr_part_kind": np.asarray(part_kind, np.int64),
            "dpmr_part_tx": np.asarray(part_tx, np.int64),
            "dpmr_bits49": np.packbits(np.stack(part_bits), axis=-1),
            "dpmr_tx": np.asarray(tx_ids, np.int64),
            "dpmr_ids": np.array([SERIAL_DPMR_SEED], np.int64)}


# -- YSF
# (data type, call mode, frame total, cycles of FN 0..FT) of the calls in
# turn: full rate with its CSD3 frames, V/D2 to all, V/D1, V/D2 in RID
# mode (short enough that a stream's first 4 s hold the first three)
_SERIAL_YSF_CALLS = ((3, 0, 1, (3, 7)), (2, 0, 5, (2, 4)),
                     (0, 0, 3, (2, 5)), (2, 1, 5, (2, 4)))
# the DCH2 text of each FN (FN 1, SRC, carries the call's callsign)
_SERIAL_YSF_TEXT = ("ALL", None, "UPLINK-A", "DOWNLINK-B", "RADIOID123",
                    "1234567890")
_SERIAL_YSF_CALLSIGNS = ("JA1YOE", "W1AW", "DL9YAB", "G4KLX")


def _close_crc(bits: np.ndarray, lo: int, crc_fn) -> np.ndarray:
    """``bits`` with its 16 bits from ``lo`` set so that ``crc_fn``, an
    affine function of the bits, gives 0."""
    base = bits.copy()
    base[lo:lo + 16] = 0
    r0 = crc_fn(base)
    A = np.zeros((16, 17), np.uint8)
    for i in range(16):
        e = base.copy()
        e[lo + i] = 1
        A[:, i] = _bits_of(crc_fn(e) ^ r0, 16)
    A[:, 16] = _bits_of(r0, 16)
    for col in range(16):
        piv = next(r for r in range(col, 16) if A[r, col])
        A[[col, piv]] = A[[piv, col]]
        for r in range(16):
            if r != col and A[r, col]:
                A[r] ^= A[col]
    base[lo:lo + 16] = A[:, 16]
    if crc_fn(base) != 0:
        raise RuntimeError("the CRC did not close")
    return base


def _ysf_k5_dibits(bits96: np.ndarray) -> np.ndarray:
    """96 bits through the K=5 code into 100 dibits in the 5×20 order
    ``YsfDecoder._fich`` and ``_dch2`` read back."""
    from dsdneo_tpu.fec import conv
    buf = _dibits_of_bits(conv.encode(bits96))
    out = np.zeros(100, np.uint8)
    for i in range(20):
        for j in range(5):
            out[i + j * 20] = buf[j + i * 5]
    return out


def _ysf_fich_dibits(fi, cm, fn, ft, mr, vp, dt, sc) -> np.ndarray:
    """The FICH (block number and total 0): 32 bits and CRC16, four
    Golay(24,12) words, the K=5 code."""
    from dsdneo_tpu.fec import blockcodes
    from dsdneo_tpu.protocol.ysf.decoder import ysf_crc16
    f = np.zeros(48, np.uint8)
    for lo, n, v in ((0, 2, fi), (4, 2, cm), (10, 3, fn), (13, 3, ft),
                     (18, 3, mr), (21, 1, vp), (22, 2, dt), (25, 7, sc)):
        f[lo:lo + n] = _bits_of(v, n)
    f = _close_crc(f, 32, ysf_crc16)
    gol = blockcodes.golay_24_12()
    return _ysf_k5_dibits(np.concatenate(
        [gol.encode(_bti(f[12 * i:12 * i + 12])) for i in range(4)]))


def _ysf_dch2_dibits(text: str) -> np.ndarray:
    """DCH2: 10 characters whitened by PN95 and CRC16, the K=5 code, as
    the 5 blocks' 20-dibit pieces in order."""
    from dsdneo_tpu.protocol.ysf.decoder import _PN95_512, ysf_crc16
    b = np.unpackbits(np.frombuffer(f"{text:<10}"[:10].encode(), np.uint8))
    d = np.concatenate([b ^ _PN95_512[:80], np.zeros(16, np.uint8)])
    return _ysf_k5_dibits(_close_crc(d, 80, ysf_crc16))


def _ysf_fr_slot(bits88: np.ndarray) -> np.ndarray:
    """88 IMBE bits → the 72 dibits of a full-rate voice slot
    (``encode_imbe_ecc``'s frame matrix, its rows top bit first, the FR
    interleave: the inverse of ``_fr_slot_to_matrix``)."""
    from dsdneo_tpu.protocol.p25.imbe_frame import (IMBE_W, IMBE_X, IMBE_Y,
                                                    IMBE_Z, encode_imbe_ecc)
    from dsdneo_tpu.protocol.ysf.decoder import _FR_INTERLEAVE, _FR_ROW_LENS
    b144 = encode_imbe_ecc(bits88)
    fr = np.zeros((8, 23), np.uint8)
    for j in range(72):
        fr[IMBE_W[j]][IMBE_X[j]] = b144[2 * j]
        fr[IMBE_Y[j]][IMBE_Z[j]] = b144[2 * j + 1]
    vch = np.concatenate([fr[n][mlen - 1::-1]
                          for n, mlen in enumerate(_FR_ROW_LENS)])
    raw = np.zeros(144, np.uint8)
    raw[_FR_INTERLEAVE] = vch
    return _dibits_of_bits(raw)


def _ysf_serial_vector() -> dict[str, np.ndarray]:
    """A 60 s YSF channel at 4800 symbols/s: a lead, then calls back to
    back (``_SERIAL_YSF_CALLS`` in turn): a header frame (FI 0), rounds
    of communication frames FN 0 to FT (FI 1), a terminator (FI 2), each
    frame the ``+YSF`` sync, the FICH (its fields through Golay(24,12),
    the K=5 code and CRC16) and five payload blocks.  V/D2 blocks carry
    the DCH2 text of the frame's FN (DST, SRC, U/L, D/L, RM1-4) and one
    AMBE frame (the tripled-bit form); V/D1 blocks 36 random DCH dibits
    and an AMBE frame (the 2450 ECC; the fifth block's is random); full
    rate five IMBE frames (the P25 ECC through the FR interleave), or on
    the CSD3 frame (FT 1, FN 0) 216 random CSD dibits and two.  Header
    and terminator payloads are random.  A frame whose end would put a
    clean false sync where it could shadow the next sync takes a new
    last block, and the lead and the tail are drawn clean."""
    names = _sync_names("ysf")
    margin = SERIAL_FAMILY_FALSE_SYNC_MAX
    rng = np.random.default_rng(SERIAL_YSF_SEED)
    sync = _sync_of("+YSF")
    frames = []
    n_frames = (SERIAL_YSF_TOTAL - SERIAL_LEAD4) // 480 - 1
    c = 0

    def blocks(f):
        """(payload dibits, AMBE bits, IMBE bits) of frame ``f``; the
        last block is drawn anew each call."""
        dt, fi, fn, ft = f["dt"], f["fi"], f["fn"], f["ft"]
        if fi != 1:
            return rng.integers(0, 4, 360).astype(np.uint8), [], []
        if dt == 3:
            n = 2 if (ft == 1 and fn == 0) else 5
            b88 = (f["imbe"] or [rng.integers(0, 2, 88).astype(np.uint8)
                                 for _ in range(n)])[:n - 1]
            b88 = b88 + [rng.integers(0, 2, 88).astype(np.uint8)]
            head = (rng.integers(0, 4, 216).astype(np.uint8) if n == 2
                    else np.zeros(0, np.uint8))
            return (np.concatenate([head] + [_ysf_fr_slot(b)
                                             for b in b88]), [], b88)
        b49 = (f["ambe"] or [rng.integers(0, 2, 49).astype(np.uint8)
                             for _ in range(4)])[:4]
        b49 = b49 + [rng.integers(0, 2, 49).astype(np.uint8)]
        if dt == 0:
            vch = [_ambe_dibits(b) for b in b49[:4]] + [
                rng.integers(0, 4, 36).astype(np.uint8)]
            return (np.concatenate([np.concatenate(
                [rng.integers(0, 4, 36).astype(np.uint8), v])
                for v in vch]), b49[:4], [])
        dch = f["dch"]
        return (np.concatenate([np.concatenate(
            [dch[20 * i:20 * i + 20],
             _ysf_vd2_dibits(b49[i], int(rng.integers(0, 2)))])
            for i in range(5)]), b49, [])

    while len(frames) < n_frames:
        dt, cm, ft, rounds = _SERIAL_YSF_CALLS[c % len(_SERIAL_YSF_CALLS)]
        call = _SERIAL_YSF_CALLSIGNS[c % len(_SERIAL_YSF_CALLSIGNS)]
        mr, vp = int(rng.integers(0, 8)), int(rng.integers(0, 2))
        sc = int(rng.integers(0, 128))
        n_comm = (ft + 1) * int(rng.integers(*rounds))
        plan = ([(0, 0)] + [(1, i % (ft + 1)) for i in range(n_comm)]
                + [(2, 0)])
        for fi, fn in plan:
            if len(frames) == n_frames:
                break
            f = {"dt": dt, "cm": cm, "ft": ft, "fi": fi, "fn": fn, "mr": mr,
                 "vp": vp, "sc": sc, "call": c, "ambe": [], "imbe": [],
                 "text": ""}
            if fi == 1 and dt == 2:
                text = (_SERIAL_YSF_TEXT[fn] if fn != 1 else call)
                if cm == 1 and fn == 0:
                    text = f"{c * 11 % 100000:05d}{c * 7 % 100000:05d}"
                f["text"] = f"{text:<10}"[:10]
                f["dch"] = _ysf_dch2_dibits(f["text"])
            f["fich"] = _ysf_fich_dibits(fi, cm, fn, ft, mr, vp, dt, sc)
            f["payload"], f["ambe"], f["imbe"] = blocks(f)
            frames.append(f)
        c += 1

    def dib(f):
        return np.concatenate([sync, f["fich"], f["payload"]])

    for a, b in zip(frames, frames[1:]):
        head = dib(b)[:48]
        for _ in range(5000):
            if _frame_ok(dib(a), head, names, margin):
                break
            a["payload"], a["ambe"], a["imbe"] = blocks(a)
        else:
            raise RuntimeError("no YSF frame end keeps the sync clear")
    lead, _ = _hunted_fill(rng, _random_chunks(SERIAL_LEAD4), "ysf", margin,
                           after=dib(frames[0]))
    body = np.concatenate([lead] + [dib(f) for f in frames])
    tail = _clean_tail(rng, SERIAL_YSF_TOTAL - len(body), "ysf", margin)
    out = np.concatenate([body, tail]).astype(np.uint8)
    pos = SERIAL_LEAD4 + 480 * np.arange(len(frames), dtype=np.int64)
    fich = np.array([[f[k] for k in ("fi", "cm", "fn", "ft", "mr", "vp",
                                      "dt", "sc")] for f in frames],
                    np.int64)
    ambe = [b for f in frames for b in f["ambe"]]
    imbe = [b for f in frames for b in f["imbe"]]
    return {"ysf_dibits": out, "ysf_frame_pos": pos, "ysf_fich": fich,
            "ysf_frame_text": np.array([f["text"] for f in frames]),
            "ysf_bits49": np.packbits(np.stack(ambe), axis=-1),
            "ysf_bits88": np.packbits(np.stack(imbe), axis=-1),
            "ysf_ids": np.array([SERIAL_YSF_SEED], np.int64)}


# -- D-STAR
# a DPRS sentence whose '!' lands at payload index 30 and whose position
# ends inside the 50 payload bytes, as the decoder's reader needs
_SERIAL_DSTAR_DPRS = "$$CRCABCD,{:<6}>API51,DSTAR*:!4903.50N/07201.75W>"
_SERIAL_DSTAR_SUFFIX = ("ID51", "ID31", "IC92", "DR2X", "FT1 ", "TH9 ",
                        "5100", "705 ")


def _dstar_serial_vector() -> dict[str, np.ndarray]:
    """A 60 s D-STAR channel at 4800 symbols/s, 2-level: transmissions,
    each after idle symbols (random, drawn clean): the ``+D-STAR HD``
    sync and the RF header (MYCALL of ``_DSTAR_CALLS`` in turn, URCALL
    CQCQCQ, RPT1 and RPT2, a suffix, the CRC-16/X25; the K=3 code, the
    interleave and the scramble), 3-6 voice superframes whose slow data
    carries the header's copy, radio text and a DPRS position, each
    with 21 AMBE frames through the 3600x2400 ECC; idle symbols to the
    end.  No end pattern: its 32 alternating symbols and 000100110101000
    correlate 0.75 with ``-D-STAR HD`` and 0.67 with ``+D-STAR HD``, so
    the serial hunt takes a false header at each.  A superframe whose last frame would put a clean false sync
    where it could shadow the next sync takes new bits, and a header
    that would do so another suffix."""
    names = _sync_names("dstar")
    margin = SERIAL_DSTAR_FALSE_SYNC_MAX
    rng = np.random.default_rng(SERIAL_DSTAR_SEED)
    vsync = _pattern_dibits("+D-STAR")
    two = (1, 3)
    parts, hd_pos, hd_oct, sf_pos, sf_sd, sf_voice, sf_bits = \
        [], [], [], [], [], [], []
    sf_kind, sf_tx = [], []
    pos, tx = 0, 0
    while True:
        n_sf = int(rng.integers(3, 7))
        gap = int(rng.integers(*SERIAL_DSTAR_GAP))
        if pos + gap + 684 + 2016 * n_sf + 400 > \
                SERIAL_DSTAR_TOTAL:
            break
        call = _DSTAR_CALLS[tx % len(_DSTAR_CALLS)]
        sfs = []
        for k in range(n_sf):
            if k == 0:
                sd, kind = _sd_blocks(0x55, b""), 0
            elif k == 2:
                sd, kind = _sd_blocks(0x35, _SERIAL_DSTAR_DPRS.format(
                    call).encode()), 2
            else:
                text = _DSTAR_TEXT[(tx + k) % len(_DSTAR_TEXT)].format(call)
                sd, kind = _sd_blocks(0x40, f"{text:<20}"[:20].encode()), 1
            sfs.append({"sd": sd, "kind": kind,
                        "bits": rng.integers(0, 2, (21, 49)).astype(
                            np.uint8)})
        # the header: the first suffix whose end keeps SF 1's sync clear
        for suffix in _SERIAL_DSTAR_SUFFIX[tx % 8:] + \
                _SERIAL_DSTAR_SUFFIX[:tx % 8]:
            hdr = _dstar_header(call, "CQCQCQ", "W1AW   B", "W1AW   G",
                                suffix)
            hd = np.concatenate([_pattern_dibits("+D-STAR HD"),
                                 _dstar_header_dibits(hdr)])
            if _frame_ok(hd, vsync, names, margin):
                break
        else:
            raise RuntimeError("no D-STAR header keeps the voice sync clear")
        sfs[0]["sd"] = _sd_blocks(0x55, hdr.tobytes())
        dib_sf = []
        for k, sf in enumerate(sfs):
            for _ in range(5000):
                d, voice = _dstar_superframe(sf["sd"], sf["bits"])
                if k + 1 == n_sf or _frame_ok(d, vsync, names, margin):
                    break
                sf["bits"][20] = rng.integers(0, 2, 49)
            else:
                raise RuntimeError("no D-STAR superframe end keeps the "
                                   "sync clear")
            sf["voice"] = voice
            dib_sf.append(d)
        idle, _ = _hunted_fill(rng, _random_chunks(gap, two), "dstar",
                               margin, after=hd)
        parts += [idle, hd] + dib_sf
        pos += len(idle)
        hd_pos.append(pos)
        hd_oct.append(hdr)
        pos += 684
        for sf in sfs:
            sf_pos.append(pos)
            sf_sd.append(sf["sd"])
            sf_voice.append(sf["voice"])
            sf_bits.append(sf["bits"])
            sf_kind.append(sf["kind"])
            sf_tx.append(tx)
            pos += 2016
        tx += 1
    rest = SERIAL_DSTAR_TOTAL - pos
    tail, _ = _hunted_fill(rng, _random_chunks(rest, two), "dstar", margin)
    dib = np.concatenate(parts + [tail]).astype(np.uint8)
    return {"dstar_dibits": dib,
            "dstar_hd_pos": np.asarray(hd_pos, np.int64),
            "dstar_hd_octets": np.stack(hd_oct),
            "dstar_sf_pos": np.asarray(sf_pos, np.int64),
            "dstar_sf_sd": np.stack(sf_sd),
            "dstar_sf_kind": np.asarray(sf_kind, np.int64),
            "dstar_sf_tx": np.asarray(sf_tx, np.int64),
            "dstar_sf_voice": np.packbits(np.stack(sf_voice), axis=-1),
            "dstar_sf_bits49": np.packbits(np.stack(sf_bits), axis=-1),
            "dstar_ids": np.array([SERIAL_DSTAR_SEED], np.int64)}


# -- M17
SERIAL_M17_SEED = 25
SERIAL_M17_TOTAL = int(SERIAL_SECONDS * 4800)
SERIAL_M17_SCR = 0xA5C3E1          # the scrambler seed, masked per subtype
SERIAL_M17_AES = bytes(range(0x40, 0x60))     # the AES-256 key
SERIAL_M17_SIGN = 0x5EC12E7A11CE0BADC0DE1234567890ABCDEF0011223344556677
SERIAL_M17_GAP = (60, 241)         # random symbols before a transmission
# the frame kinds of ``m17_frames``; M17_PRE is the LSF hit the serial
# hunt takes in a BERT transmission's preamble
M17_LSF, M17_STR, M17_SIG, M17_PKT, M17_BRT, M17_PRE = range(6)
_SERIAL_M17_CALLS = (("N0CALL", "W1AW"), ("ALL", "DL1ABC"),
                     ("M17-M17", "G4KLX"), ("BROADCAST", "VK2XYZ"),
                     ("K6DSS", "JA1YKX"))
# GNSS v2 METAs: (validity, bearing, latitude, longitude, altitude + 1500
# m, speed in quarter km/h), latitude and longitude signed 24-bit
_SERIAL_M17_GNSS = ((0x6, 0x12E, 0x1E3A47, 0xCD8F21, 1812, 0x4B2),
             (0x0, 0x05A, 0x2A0B1C, 0x0B7F03, 0, 0))


def _m17_text_meta(text: str) -> tuple[bytes, str]:
    """A one-block META text (13 characters) and the line it reads as."""
    raw = f"{text:<13}"[:13].encode()
    return bytes([0x11]) + raw, "\n Meta Text Data: " + raw.decode().rstrip()


def _m17_gnss_meta(k: int) -> tuple[bytes, str]:
    """A GNSS v2 META (0x81; latitude and longitude over 2²³−1 of ±90°
    and ±180°) and the line it reads as."""
    v, brg, lat, lon, alt, spd = _SERIAL_M17_GNSS[k % 2]
    meta = bytes([0x81, 0, (v << 4) | (brg >> 8), brg & 0xFF,
                  lat >> 16, (lat >> 8) & 0xFF, lat & 0xFF,
                  lon >> 16, (lon >> 8) & 0xFF, lon & 0xFF,
                  alt >> 8, alt & 0xFF, spd >> 4, (spd & 0xF) << 4])

    def s24(x):
        return x - (1 << 24) if x & 0x800000 else x
    line = ("\n Meta GNSS Position Data"
            f" Lat: {s24(lat) * 90.0 / 8388607.0:.5f}"
            f" Lon: {s24(lon) * 180.0 / 8388607.0:.5f}")
    if v & 0x2:
        line += f" Alt: {alt - 1500} m"
    if v & 0x4:
        line += f" Speed: {spd / 4.0:.1f} km/h Bearing: {brg}"
    return meta, line


def _m17_program(c: int) -> list[dict]:
    """Cycle ``c`` of the M17 stream's transmissions (the BERT run in
    the first only: the receiver's PRBS9 lock is kept across runs)."""
    dst, src = _SERIAL_M17_CALLS[c % len(_SERIAL_M17_CALLS)]
    text, tline = _m17_text_meta(f"CQ M17 RUN {c}")
    gnss, gline = _m17_gnss_meta(c)
    ext = f"{src}/P".encode()
    prog = [
        dict(kind="stream", dst=dst, src=src, dt=2, n=40, meta=text,
             note=tline),
        dict(kind="stream", dst=src, src=dst, dt=3, n=30, adata=True),
        dict(kind="stream", dst=dst, src=src, dt=2, n=36, enc=1, est=0),
        dict(kind="packet", dst=dst, src=src,
             text=f"M17 SMS {c}: THE SERIAL PATH READS THIS"),
        dict(kind="stream", dst=dst, src=src, dt=2, n=60, enc=1, est=1,
             drop=(20, 23)),
        dict(kind="stream", dst=src, src=dst, dt=2, n=24, est=1, meta=gnss,
             note=gline),
        dict(kind="stream", dst=dst, src=src, dt=2, n=36, enc=1, est=2,
             late=12),
        dict(kind="stream", dst=dst, src=src, dt=2, n=36, enc=2),
        dict(kind="stream", dst=src, src=dst, dt=2, n=30, sign=True),
        dict(kind="stream", dst=dst, src=src, dt=2, n=12, est=2,
             meta=bytes([0x82]) + ext,
             note="\n Meta Extended Callsign Data: " + ext.decode())]
    return prog + ([dict(kind="bert", n=12)] if c == 0 else [])


def _m17_shadowed(dib: np.ndarray, s: int) -> tuple[bool, bool]:
    """Whether a clean false M17 sync could take the place of the frame
    sync at ``s`` in the greedy pick: (one starting 15 to 8 symbols
    before it — a 16-symbol LSF sync ends in the STR sync, which alone
    scores 0.5 — or a near-perfect one 7 to 1 before it, both set by
    the previous frame's tail; a near-perfect one 1 to 7 symbols after
    it, in the pick's refinement window: the BRT sync ends in 1111, so a
    payload opening 3313 reads as −STR there)."""
    lv = np.array([1.0, 3.0, -1.0, -3.0])[dib[s - 15:s + 23]]
    before = inside = False
    for d in _sync_defs("m17"):
        n = len(d.levels)
        c = np.abs(np.correlate(lv[:22 + n], d.levels, "valid")) / (9.0 * n)
        before |= bool(c[:8].max() >= (SERIAL_FAMILY_FALSE_SYNC_MAX
                                        if n == 16 else 0.8)
                       or c[8:15].max() >= 0.8)
        inside |= bool(c[16:].max() >= 0.8)
    return before, inside


def _m17_onair(voice: np.ndarray, spec: dict, meta: bytes) -> np.ndarray:
    """The transmitted 128-bit payloads of a stream's voice frames: the
    encoder's scrambler (one keystream from the seed) or AES-CTR
    applied."""
    from dsdneo_tpu.crypto.keystream import aes_ctr_keystream
    from dsdneo_tpu.protocol.m17.decoder import (aes_ctr_counter,
                                                 scrambler_keystream)
    out = voice.copy()
    if spec.get("enc") == 1:
        ks, _ = scrambler_keystream(spec.get("est", 0), SERIAL_M17_SCR,
                                    128 * len(voice))
        out ^= ks.reshape(len(voice), 128)
    elif spec.get("enc") == 2:
        for i in range(len(voice)):
            ks = aes_ctr_keystream(SERIAL_M17_AES, aes_ctr_counter(meta, i),
                                   16)
            out[i] ^= np.unpackbits(ks)
    return out


def _m17_stream_draw(rng, spec: dict):
    """A stream transmission no false sync can shadow a heard frame of:
    voice bits drawn again for the frame before a shadowed one and for
    one whose payload opens like a sync, the CAN for the first frame
    (the LSF's tail depends mostly on the callsigns and the META: after
    16 CANs, random six-character DST and SRC), the signing nonce for a
    signature frame; then the dropped frames cut out and, for a late
    entry, the frames before it.  The frames are assembled here from the
    JAX encoder's parts (``encode_lsf_frame``, ``encode_stream_frame``,
    the signature of ``p256_sign_digest``), only those that changed
    encoded again, and the drawn transmission is checked against
    ``encode_stream_transmission``.  Returns (dibits, the heard frames'
    indices, their sync starts, voice bits, DST, SRC, CAN, META, LSF)."""
    from dsdneo_tpu.crypto.ecdsa import p256_sign_digest
    from dsdneo_tpu.protocol.m17 import encoder as ME
    n = spec["n"]
    sign = bool(spec.get("sign"))
    n_all = n + (4 if sign else 0)
    lo, hi = spec.get("drop", (0, 0))
    first = spec.get("late", 0)
    heard = [k for k in range(first, n_all) if not lo <= k < hi]
    enc, est = spec.get("enc", 0), spec.get("est", 0)
    meta = spec.get("meta", b"")
    if enc == 2:                        # the AES-CTR nonce
        meta = rng.integers(0, 256, 14).astype(np.uint8).tobytes()
    meta = (meta + bytes(14))[:14]
    voice = rng.integers(0, 2, (n, 128)).astype(np.uint8)
    w = 128
    if spec.get("adata"):
        w = 64
        for i in range(n):
            voice[i, 64:] = np.unpackbits(np.frombuffer(
                (f"AD {i:03d}".encode() + bytes(8))[:8], np.uint8))
    can = int(rng.integers(0, 16))
    dst, src, tweak = spec["dst"], spec["src"], 0
    sign_k = int(rng.integers(1, 1 << 62))
    sync_str = np.array(ME.SYNC_STR, np.uint8)
    frames: dict[int, np.ndarray] = {}
    head = lsf = None
    for _ in range(2000):
        if head is None:
            lsf = ME.build_lsf(dst, src, can=can, stream=True,
                               dt=spec["dt"], meta=meta, enc=enc,
                               enc_st=est, signed_stream=sign)
            head = np.concatenate([np.array([3, 1] * 24, np.uint8),
                                   np.array(ME.SYNC_LSF, np.uint8),
                                   ME.encode_lsf_frame(lsf)])
            frames = {}
        ota = _m17_onair(voice, spec, meta)
        for k in range(n):
            if k not in frames:
                frames[k] = np.concatenate([sync_str, ME.encode_stream_frame(
                    lsf, k % 6, k, ota[k], eot=not sign and k == n - 1)])
        if sign:
            digest = bytearray(16)
            for k in range(n):
                d = bytes(a ^ b for a, b in zip(digest,
                                                np.packbits(ota[k])))
                digest = bytearray(d[1:] + d[:1])
            sig = p256_sign_digest(bytes(digest), SERIAL_M17_SIGN, sign_k)
            for j, fn in enumerate((0x7FFC, 0x7FFD, 0x7FFE, 0x7FFF)):
                chunk = np.unpackbits(np.frombuffer(
                    sig[16 * j:16 * (j + 1)], np.uint8))
                frames[n + j] = np.concatenate([sync_str,
                                                ME.encode_stream_frame(
                    lsf, (n + j) % 6, fn, chunk, eot=j == 3)])
        kept = [k for k in range(n_all) if not lo <= k < hi]
        dib = np.concatenate([head] + [frames[k] for k in kept])
        starts = np.zeros(n_all, np.int64)
        starts[kept] = len(head) + 192 * np.arange(len(kept))
        sh = {k: _m17_shadowed(dib, int(starts[k])) for k in heard}
        bad = [k for k in heard if (k > first or k == 0) and sh[k][0]]
        inside = [k for k in heard if sh[k][1]]
        if not bad and not inside:
            break
        if bad and bad[0] == 0:
            tweak += 1
            can = (can + 1) % 16
            if tweak % 16 == 0:
                dst, src = ("".join(ME.BASE40[1 + int(i)] for i in
                                    rng.integers(0, 36, 6))
                            for _ in range(2))
            head = None
        if any(k > n for k in bad) or any(k >= n for k in inside):
            sign_k += 1
        redraw = {heard[heard.index(k) - 1] for k in bad if k} | set(inside)
        for k in redraw:
            if k < n:
                voice[k, :w] = rng.integers(0, 2, w)
                frames.pop(k, None)
    else:
        raise RuntimeError("no M17 draw keeps every frame sync clear")
    kw = dict(can=can, dt=spec["dt"], enc=enc, enc_st=est, meta=meta)
    if enc == 1:
        kw["scrambler_seed"] = SERIAL_M17_SCR
    if enc == 2:
        kw["aes_key"] = SERIAL_M17_AES
    if sign:
        kw["sign_key"], kw["sign_k"] = SERIAL_M17_SIGN, sign_k
    full = ME.encode_stream_transmission(dst, src, voice, **kw)
    tail = full[len(head) + 192 * n_all:]
    if not np.array_equal(full[:len(head) + 192 * n_all], np.concatenate(
            [head] + [frames[k] for k in range(n_all)])):
        raise RuntimeError("the assembled M17 transmission is not the "
                           "encoder's")
    dib = np.concatenate([dib, tail])
    if first:
        dib = dib[starts[first]:]
        starts = starts - starts[first]
    return dib, heard, starts, voice, dst, src, can, meta, lsf


def _m17_serial_vector() -> dict[str, np.ndarray]:
    """A 60 s M17 channel at 4800 symbols/s: cycles of transmissions of
    the JAX package's encoders (``protocol.m17.encoder``), each after
    random idle symbols drawn clean: a clear 3200 call whose LSF carries
    META text, a 1600 call with A_DATA text, scrambler calls of the
    three subtypes (one with three frames dropped, so the decoder
    advances the LFSR over the gap; one heard from its 12th frame, a
    late entry read as clear until the LICH gives its LSF), an SMS
    packet, a clear call with a GNSS META, an AES-CTR call, a signed
    stream, a call with an extended-callsign META; in the first cycle a
    BERT run.  The BERT transmission's preamble and first BRT sync
    correlate 0.75 with the LSF sync 8 symbols early: the serial hunt
    takes an LSF there (CRC ERR), which shadows the first BRT frame, as
    in the JAX package (``M17_PRE``).  Returns the dibits, every frame
    the decoder must take (``m17_frames``: sync start, kind,
    transmission, FN with its EOT bit, LICH counter or packet block,
    voice row), the transmissions (``m17_tx``: kind, CAN, type word,
    frames, late entry, dropped frames, BERT state; their callsigns,
    notes, META and LSFs), every voice frame's on-air payload and the
    payload the decoder hands Codec2 (clear, or on-air where it cannot
    decrypt yet), the SMS texts and the keys."""
    from dsdneo_tpu.crypto.ecdsa import p256_public_key
    from dsdneo_tpu.protocol.m17 import encoder as ME
    rng = np.random.default_rng(SERIAL_M17_SEED)
    margin = SERIAL_FAMILY_FALSE_SYNC_MAX
    parts, frames, txs, calls, notes, metas, lsfs = [], [], [], [], [], [], []
    onair, handed, sms = [], [], []
    pos, c = 0, 0
    while True:
        for spec in _m17_program(c):
            gap = int(rng.integers(*SERIAL_M17_GAP))
            kind = spec["kind"]
            t = len(txs)
            row = [0, 0, 0, spec.get("n", 0), spec.get("late", 0),
                   *spec.get("drop", (0, 0)), 0]
            new, new_onair, new_handed, new_sms = [], [], [], []
            if kind == "stream":
                dib, heard, starts, voice, dst, src, can, meta, lsf = \
                    _m17_stream_draw(rng, spec)
                spec = {**spec, "dst": dst, "src": src}
                n = spec["n"]
                ota = _m17_onair(voice, spec, meta)
                first = spec.get("late", 0)
                if not first:
                    new.append((48, M17_LSF, t, -1, -1, -1))
                for k in heard:
                    s = int(starts[k])
                    if k >= n:
                        new.append((s, M17_SIG, t,
                                    (0x7FFC, 0x7FFD, 0x7FFE, 0xFFFF)[k - n],
                                    k % 6, -1))
                        continue
                    eot = k == n - 1 and not spec.get("sign")
                    new.append((s, M17_STR, t, k | (0x8000 if eot else 0),
                                k % 6, len(onair) + len(new_onair)))
                    new_onair.append(ota[k])
                    # a late entry's frames before the LICH gives the LSF
                    # (its sixth) are read with the last LSF's setting:
                    # clear
                    new_handed.append(ota[k] if first and k < first + 5
                                      else voice[k])
                row[:3] = 0, can, _bti(lsf[96:112])
            elif kind == "packet":
                for can in range(16):
                    dib = ME.encode_packet_transmission(
                        spec["dst"], spec["src"], spec["text"], can=can)
                    nf = (len(dib) - 248 - 144) // 192
                    starts = 248 + 192 * np.arange(nf)
                    if not any(any(_m17_shadowed(dib, int(s)))
                               for s in starts):
                        break
                else:
                    raise RuntimeError("no CAN keeps the packet clear")
                lsf = ME.build_lsf(spec["dst"], spec["src"], can=can,
                                   stream=False, dt=1)
                meta = bytes(14)
                new.append((48, M17_LSF, t, -1, -1, -1))
                new += [(int(s), M17_PKT, t, -1, i, len(sms))
                        for i, s in enumerate(starts)]
                new_sms.append(spec["text"])
                row[:3] = 1, can, _bti(lsf[96:112])
            else:
                for state in range(1, 512):
                    dib = ME.encode_bert_transmission(spec["n"], state)
                    starts = 48 + 192 * np.arange(spec["n"])
                    if not any(any(_m17_shadowed(dib, int(s)))
                               for s in starts[1:]):
                        break
                else:
                    raise RuntimeError("no BERT state keeps the run clear")
                meta, lsf = bytes(14), np.zeros(240, np.uint8)
                new.append((40, M17_PRE, t, -1, -1, -1))
                new += [(int(s), M17_BRT, t, -1, i, -1)
                        for i, s in enumerate(starts) if i]
                row[0], row[7] = 2, state
            if pos + gap + len(dib) > SERIAL_M17_TOTAL - 400:
                break
            idle, _ = _hunted_fill(rng, _random_chunks(gap), "m17", margin,
                                   after=dib)
            pos += len(idle)
            frames += [(pos + s, *rest) for s, *rest in new]
            parts += [idle, dib]
            pos += len(dib)
            onair += new_onair
            handed += new_handed
            sms += new_sms
            txs.append(row)
            calls.append((ME.encode_callsign(spec.get("dst", "")),
                          ME.encode_callsign(spec.get("src", ""))))
            notes.append(spec.get("note", ""))
            metas.append(np.frombuffer(meta, np.uint8))
            lsfs.append(lsf)
        else:
            c += 1
            continue
        break
    tail = _clean_tail(rng, SERIAL_M17_TOTAL - pos, "m17", margin)
    dib = np.concatenate(parts + [tail]).astype(np.uint8)
    return {"m17_dibits": dib,
            "m17_frames": np.asarray(sorted(frames), np.int64),
            "m17_tx": np.asarray(txs, np.int64),
            "m17_tx_calls": np.asarray(calls, np.int64),
            "m17_tx_note": np.asarray(notes),
            "m17_tx_meta": np.stack(metas),
            "m17_tx_lsf": np.packbits(np.stack(lsfs), axis=-1),
            "m17_onair": np.packbits(np.stack(onair), axis=-1),
            "m17_handed": np.packbits(np.stack(handed), axis=-1),
            "m17_sms": np.asarray(sms),
            "m17_aes_key": np.frombuffer(SERIAL_M17_AES, np.uint8),
            "m17_pubkey": np.frombuffer(p256_public_key(SERIAL_M17_SIGN),
                                        np.uint8),
            "m17_ids": np.array([SERIAL_M17_SEED, SERIAL_M17_SCR], np.int64)}


# -- P25 Phase 2
SERIAL_P2_SEED = 26            # synth_p2_voice_stream's first seed
SERIAL_P2_SF = (83, 83)        # superframes: clear, then ADP-keyed
SERIAL_P2_PARAMS = (0xBEE00, 0x14C, 0x140)   # WACN, SYSID, NAC
SERIAL_P2_KEY = 0x1A2B3C4D5E   # the ADP key, in the KeyRing under
SERIAL_P2_KID = 0x0077         # SERIAL_P2_KID
SERIAL_P2_MI = 0x1122334455667788
SERIAL_P2_TG = (1801, 1802)    # each slot's talkgroup and source
SERIAL_P2_SRC = (700001, 700002)
P2_SF_DIBITS = 2160            # 3 frames of a 20-dibit sync and 700 dibits
P2_SYNTH_LEAD = 40             # synth_p2_voice_stream's lead
P2_LEAD = 48                   # the stream's lead (zeros)


def _p2_ptt(slot: int, alg: int, kid: int, mi: int) -> list[int]:
    """A MAC_PTT message: MI, ALG, KID, source, talkgroup
    (``P25P2Decoder._mac_pdu``'s octets 1-17)."""
    src, tg = SERIAL_P2_SRC[slot], SERIAL_P2_TG[slot]
    return ([(mi >> (56 - 8 * i)) & 0xFF for i in range(8)]
            + [alg, kid >> 8, kid & 0xFF, 0, src >> 16, (src >> 8) & 0xFF,
               src & 0xFF, tg >> 8, tg & 0xFF])


def _p2_serial_vector() -> dict[str, np.ndarray]:
    """A 60 s P25 Phase 2 channel at 6000 symbols/s: superframes of the
    JAX package's ``engine.p2batch.synth_p2_voice_stream`` (both slots
    running 4V×4 + 2V with their ESS, the ISCH, the DUIDs and the
    WACN/SYS/NAC scramble), a clear half then an ADP-keyed half (ALG
    0xAA, the key's RC4 keystream from drop 256 each superframe), each
    superframe's two LCCH timeslots (global 10 and 11) replaced by
    scrambled SACCH bursts carrying each slot's MAC_PTT (ALG 0x80 in the
    clear half; 0xAA, the KID and the MI in the keyed half), so the
    serial decoder can also recover the scramble parameters blind.  One
    superframe a call, from the next seed whose superframe puts no clean
    false sync where it could shadow a frame sync (random voice bits
    sometimes correlate 0.64 with −P25p2 eleven symbols early); a
    48-symbol lead, random symbols drawn clean to the end.  Returns the
    dibits, the frames' sync starts and timeslot DUIDs, every AMBE
    frame's frame, timeslot, slot, superframe, half and place with its
    clear and on-air parameter bits, and the IDs and key."""
    from dsdneo_tpu.crypto.keystream import rc4_keystream
    from dsdneo_tpu.engine.p2batch import synth_p2_voice_stream
    from dsdneo_tpu.protocol.p25 import encode as PE
    from dsdneo_tpu.protocol.p25 import p2_xcch
    rng = np.random.default_rng(SERIAL_P2_SEED)
    names = _sync_names("p25p2")
    margin = SERIAL_FAMILY_FALSE_SYNC_MAX
    wacn, sysid, nac = SERIAL_P2_PARAMS
    scr = p2_xcch.generate_scramble_bits(wacn, sysid, nac, 12 * 360 + 380)
    parts = [np.zeros(P2_LEAD, np.uint8)]
    fpos, fduid, vrow, vplain, vonair = [], [], [], [], []
    seed, sf = SERIAL_P2_SEED, 0
    for half, n_sf in enumerate(SERIAL_P2_SF):
        alg, kid, key, mi = ((0xAA, SERIAL_P2_KID, SERIAL_P2_KEY,
                              SERIAL_P2_MI) if half else (0, 0, 0, 0))
        ks = (rc4_keystream((key & 0xFFFFFFFFFF).to_bytes(5, "big")
                            + mi.to_bytes(8, "big"), 18 * 7, drop=256)
              if half else np.zeros(18 * 7, np.uint8))
        for _ in range(n_sf):
            while True:
                _x, d, b49 = synth_p2_voice_stream(
                    1, seed=seed, wacn=wacn, sysid=sysid, nac=nac, alg=alg,
                    kid=kid, key=key, mi=mi)
                seed += 1
                d = d[P2_SYNTH_LEAD:P2_SYNTH_LEAD + P2_SF_DIBITS].copy()
                for g in (10, 11):
                    payload = PE.p2_mac_payload(
                        1, [_p2_ptt(g % 2, alg or 0x80, kid, mi)])
                    ts = PE.p2_xcch_ts(payload, 3, g, scramble=scr)[
                        :320 if g == 11 else 360]
                    off = 720 * (g // 4) + 20 + 180 * (g % 4)
                    d[off:off + len(ts) // 2] = (ts[0::2] << 1) | ts[1::2]
                lead = parts[-1][-48:]
                seg = np.concatenate([lead, d])
                cut = len(lead) + 720 * np.arange(3)
                if all(_frame_ok(seg[:c], seg[c:], names, margin)
                       for c in cut):
                    break
            base = sum(len(q) for q in parts)
            parts.append(d)
            nfr = {0: 0, 1: 0}
            for fr in range(3):
                fpos.append(base + 720 * fr)
                duids = []
                for k in range(4):
                    g = 4 * fr + k
                    slot, j = g % 2, g // 2
                    duids.append(0 if j < 4 else (6 if j == 4 else 3))
                    for f in range(4 if j < 4 else (2 if j == 4 else 0)):
                        i = nfr[slot]
                        c = np.packbits(b49[slot, i]) ^ ks[7 * i:7 * i + 7]
                        vrow.append((len(fpos) - 1, k, slot, sf, half, f))
                        vplain.append(b49[slot, i])
                        vonair.append(np.unpackbits(c)[:49])
                        nfr[slot] += 1
                fduid.append(duids)
            sf += 1
    dib = np.concatenate(parts)
    tail = _hunted_fill(rng, _random_chunks(int(SERIAL_SECONDS * 6000)
                                            - len(dib)), "p25p2", margin)[0]
    return {"p2_dibits": np.concatenate([dib, tail]).astype(np.uint8),
            "p2_frame_pos": np.asarray(fpos, np.int64),
            "p2_frame_duid": np.asarray(fduid, np.int64),
            "p2_voice": np.asarray(vrow, np.int64),
            "p2_voice_clear": np.packbits(np.stack(vplain), axis=-1),
            "p2_voice_onair": np.packbits(np.stack(vonair), axis=-1),
            "p2_ids": np.array([*SERIAL_P2_PARAMS, SERIAL_P2_KEY,
                                SERIAL_P2_KID, SERIAL_P2_MI,
                                *SERIAL_P2_TG, *SERIAL_P2_SRC,
                                SERIAL_P2_SEED], np.int64),
            "p2_halves": np.asarray(SERIAL_P2_SF, np.int64)}

# detect_mode's pick on each family's 4 s probe (serialvec.auto_probe), as
# the JAX package makes it (checked when the streams are built): X2-TDMA
# reads as p25p1 and D-STAR as p25p2, JAX behaviours the port copies
SERIAL_AUTO_PICKS = {"p25p1": "p25p1", "provoice": "edacs", "dmr": "dmr",
                     "x2tdma": "p25p1", "nxdn48": "nxdn48",
                     "nxdn96": "nxdn96", "dpmr": "dpmr", "ysf": "ysf",
                     "dstar": "p25p2", "m17": "m17", "p25p2": "p25p2"}


def build_serial_tables(check: bool = True) -> dict[str, np.ndarray]:
    """The serial decode path's eleven 60 s streams, each held to the JAX
    package's ``decode_samples`` over its whole length when ``check``
    (the port's ``engine.serialvec`` judges: every LDU, LC, ESS and
    keyed frame, every EDACS frame and ProVoice superframe, every DMR
    burst's lines and AMBE frame, keyed ones decrypted, upright and on
    an inverted channel, every X2-TDMA superframe's frames, every NXDN
    frame's line and AMBE frame at both rates, every dPMR part's IDs,
    channel code and AMBE frames, every YSF frame's FICH, DCH2 text and
    AMBE or IMBE frames, every D-STAR header and superframe, every M17
    frame with its voice payloads, signature, SMS and BERT counts, every
    P25p2 frame and AMBE frame with and without the scramble parameters
    and the ADP key)."""
    t = {**_p25_call_vector(), **_pv_vector(), **_dmr_call_vector(),
         **_x2_vector(), **_nxdn_serial_vector(), **_dpmr_serial_vector(),
         **_ysf_serial_vector(), **_dstar_serial_vector(),
         **_m17_serial_vector(), **_p2_serial_vector()}
    t["auto_families"] = np.array(list(SERIAL_AUTO_PICKS))
    t["auto_picks"] = np.array(list(SERIAL_AUTO_PICKS.values()))
    if check:
        _check_serial(t)
    return t


def _check_serial(t: dict[str, np.ndarray]) -> None:
    from dsdneo_tpu.crypto.keyring import KeyRing
    from dsdneo_tpu.engine.decoder import decode_samples
    from dsdneo_tpu_torch.engine import serialvec as SV
    kr = KeyRing()
    kr.scalar[SERIAL_KID] = SERIAL_KEY
    sink = SV.ImbeSink()
    ctx = decode_samples(SV.p25_iq(t), "p25p1", keyring=kr, mbe_sink=sink)
    SV.judge_p25(t, ctx, sink)
    ctx = decode_samples(SV.pv_iq(t), "provoice")
    SV.judge_pv(t, ctx)
    import dsdneo_tpu.vocoder.mbe as jmbe
    kr = KeyRing()
    kr.scalar[SERIAL_DMR_KID] = SERIAL_DMR_KEY
    for invert in (False, True):
        sink = SV.ImbeSink()
        attrs = {"dmr_bp_key_id": SERIAL_DMR_BP}
        if invert:
            attrs["force_polarity"] = {"dmr": True}
        ctx = decode_samples(SV.dmr_iq(t, invert=invert), "dmr", keyring=kr,
                             mbe_sink=sink, state_attrs=attrs)
        SV.judge_dmr(t, ctx, sink, invert=invert, rc4=True, bp=True)
    with SV.AmbeSpy(jmbe) as spy:
        ctx = decode_samples(SV.x2_iq(t), "x2tdma")
    SV.judge_x2(t, ctx, spy)
    for mode in ("nxdn48", "nxdn96"):
        with SV.AmbeSpy(jmbe) as spy:
            ctx = decode_samples(SV.nxdn_iq(t, mode=mode), mode)
        SV.judge_nxdn(t, ctx, spy, mode)
    with SV.AmbeSpy(jmbe) as spy:
        ctx = decode_samples(SV.dpmr_iq(t), "dpmr")
    SV.judge_dpmr(t, ctx, spy)
    with SV.AmbeSpy(jmbe) as ambe, \
            SV.AmbeSpy(jmbe, "decode_imbe_4400") as imbe:
        ctx = decode_samples(SV.ysf_iq(t), "ysf")
    SV.judge_ysf(t, ctx, ambe, imbe)
    ctx = decode_samples(SV.dstar_iq(t), "dstar")
    SV.judge_dstar(t, ctx)
    from dsdneo_tpu.protocol.m17.decoder import M17Decoder
    udp = SV.UdpSink()
    with SV.M17Spy(M17Decoder) as spy:
        ctx = decode_samples(SV.m17_iq(t), "m17", m17_udp=udp,
                             state_attrs=SV.m17_attrs(t))
    SV.judge_m17(t, ctx, spy, udp)
    kr = KeyRing()
    kr.scalar[SERIAL_P2_KID] = SERIAL_P2_KEY
    for keyed, blind in ((True, False), (True, True), (False, False)):
        with SV.AmbeSpy(jmbe) as spy:
            ctx = decode_samples(SV.p2_iq(t), "p25p2",
                                 keyring=kr if keyed else None,
                                 p2_params=None if blind
                                 else SERIAL_P2_PARAMS)
        SV.judge_p2(t, ctx, spy, keyed=keyed, blind=blind)
    from dsdneo_tpu.engine.decoder import detect_mode
    for fam in SV.AUTO_FAMILIES:
        got = detect_mode(SV.auto_probe(t, fam)).name
        if got != SV.auto_pick(t, fam):
            raise RuntimeError(f"detect_mode picks {got!r} on the {fam} "
                               f"probe, not {SV.auto_pick(t, fam)!r}")


# -- the trunked fleet's bands (fleet_tables.npz) -----------------------------
OUT_FLEET = os.path.join(DATA, "fleet_tables.npz")
FLEET_NAC = 0x293
# the 2.4 MHz band: four P25 systems, each granting three calls spaced
# 125 kHz (20 channels of its 6.25 kHz raster) above its control channel
WIDE_CC_OFFS = (-1_050_000, -450_000, 150_000, 750_000)
WIDE_CALL_STEP = 125_000
WIDE_LDUS = 34            # 6.1 s of LDUs a call
DMR_FLEET = (460_000_000.0, -144_000, 192_000, 24, 101, 5555)
NXDN_FLEET = (451_000_000.0, -96_000, 144_000, 0x0A5, 200, 31)
EDACS_FLEET = (860_000_000.0, -96_000, 144_000, 7, 0x155, 77)
P2_FLEET = (851_000_000.0, -96_000, 20 * 6250, 301, 302)


def _netstat_tsbk() -> np.ndarray:
    from dsdneo_tpu.protocol.p25 import encode as E
    return E.tsbk_bytes(0x3B, [0, 0x92, 0x06, 0x50, 0xD5, 0, 0, 0], lb=True)


def _ldu_stream(rng, n_ldus: int, seed: int, lead: int = 30):
    """Random lead dibits, then ``n_ldus`` LDUs of
    ``random_voice_ldus(n_ldus, seed)`` (LDU1/LDU2 alternating): the
    dibits, the LDU starts and the 88 IMBE bits of every frame."""
    from dsdneo_tpu.fec.device import imbe_ecc_batch
    from dsdneo_tpu.protocol.p25 import encode as E
    ldus = E.random_voice_ldus(n_ldus, seed=seed)
    parts = [rng.integers(0, 4, lead).astype(np.uint8)]
    starts = []
    at = lead
    for i in range(n_ldus):
        f = E.ldu_frame(FLEET_NAC, ldus[i], duid=5 if i % 2 == 0 else 10,
                        seed=i)
        starts.append(at)
        parts.append(f)
        at += len(f)
    bits88, errs = imbe_ecc_batch(ldus.reshape(-1, 144))
    if int(np.asarray(errs).max()) != 0:
        raise RuntimeError("clean voice frames decode with errors")
    return (np.concatenate(parts), np.asarray(starts, np.int64),
            np.asarray(bits88).astype(np.uint8))


def _tsdu_stream(rng, nac: int, frame_at, need: int) -> np.ndarray:
    """A P25 control channel of ``need`` dibits: 60 random dibits, then
    TSDUs ``frame_at(k, dibit position)`` each followed by 24 random."""
    parts, total, k = [rng.integers(0, 4, 60).astype(np.uint8)], 60, 0
    while total < need:
        f = frame_at(k, total)
        parts.append(f)
        parts.append(rng.integers(0, 4, 24).astype(np.uint8))
        total += len(f) + 24
        k += 1
    return np.concatenate(parts)[:need]


def _bench_fleet_vector() -> dict[str, np.ndarray]:
    """The JAX bench's trunked cell (``bench.py:526-544``): 2 s of a P25
    control channel that repeats IDEN_UP, the grant of TG 101 on channel
    24 and NET_STS in every TSDU, and the granted call's LDUs."""
    from dsdneo_tpu.protocol.p25 import encode as E
    from dsdneo_tpu_torch.engine import fleetvec as FV
    iden = E.iden_up_tsbk(1, FV.BENCH_CENTER, 6250.0)
    frame = E.tsdu_frame(FLEET_NAC, [
        iden, E.group_grant_tsbk((1 << 12) | 24, tg=FV.BENCH_TG, src=5555),
        _netstat_tsbk()])
    rng = np.random.default_rng(0)
    cc = _tsdu_stream(rng, FLEET_NAC, lambda k, at: frame, 2 * 4800)
    vc, starts, bits88 = _ldu_stream(rng, int(2.0 / 0.185) + 1, 3)
    return {"bench_cc_dibits": cc, "bench_vc_dibits": vc,
            "bench_vc_starts": starts, "bench_vc_bits88": bits88}


def _wide_fleet_vector() -> dict[str, np.ndarray]:
    """Four P25 systems in a 2.4 MHz band, 6 s: system s (NAC 0x290 + s,
    iden 1 based at its control channel, 6.25 kHz raster) grants TG
    1000 + 10 s + j on channel 20 (j + 1), j = 0..2, cycling; the calls
    of odd index 3 s + j stop being granted at 3 s (their voice ends
    there too)."""
    from dsdneo_tpu.protocol.p25 import encode as E
    from dsdneo_tpu_torch.engine import fleetvec as FV
    rng = np.random.default_rng(41)
    need = FV.WIDE_SECONDS * 4800
    quiet = int(FV.WIDE_SILENT_AFTER * 4800) - 200
    cc, vc, starts, bits, offs, tgs = [], [], [], [], [], []
    for s, cc_off in enumerate(WIDE_CC_OFFS):
        nac = 0x290 + s
        iden = E.iden_up_tsbk(1, FV.WIDE_CENTER + cc_off, 6250.0)
        grants = [E.group_grant_tsbk((1 << 12) | (20 * (j + 1)),
                                     tg=1000 + 10 * s + j, src=7000 + j)
                  for j in range(3)]

        def frame_at(k, at, s=s, nac=nac, iden=iden, grants=grants):
            live = [j for j in range(3)
                    if (3 * s + j) % 2 == 0 or at < quiet]
            return E.tsdu_frame(nac, [iden, grants[live[k % len(live)]],
                                      _netstat_tsbk()])

        cc.append(_tsdu_stream(rng, nac, frame_at, need))
        for j in range(3):
            d, st, b = _ldu_stream(rng, WIDE_LDUS, 100 + 3 * s + j)
            vc.append(d[:need])
            starts.append(st)
            bits.append(b)
            offs.append(cc_off + WIDE_CALL_STEP * (j + 1))
            tgs.append(1000 + 10 * s + j)
    return {"wide_cc_dibits": np.stack(cc),
            "wide_cc_offs": np.asarray(WIDE_CC_OFFS, np.int64),
            "wide_vc_dibits": np.stack(vc),
            "wide_vc_starts": np.stack(starts),
            "wide_vc_bits88": np.stack(bits),
            "wide_vc_offs": np.asarray(offs, np.int64),
            "wide_vc_tgs": np.asarray(tgs, np.int64)}


def _mode_fleet_vectors() -> dict[str, np.ndarray]:
    """2 s each: the DMR TSCC with its TV_GRANT and the DMR voice
    (``tests/test_fleettrunk_dmr.py:19-55``), the NXDN RCCH with its
    VCALL_ASSGN (``tests/test_fleettrunk_nxdn.py:24-101``) and the voice
    frames of the serial NXDN stream, the EDACS CC with its analog group
    assignment (``tests/test_fleettrunk_edacs.py:18-67``), and the P25
    CC granting both slots of a TDMA channel with the Phase 2 voice
    (``tests/test_fleettrunk_p2.py:25-73``)."""
    from dsdneo_tpu.engine.dmrbatch import synth_voice_stream
    from dsdneo_tpu.engine.p2batch import synth_p2_voice_stream
    from dsdneo_tpu.protocol.dmr import encode as DE
    from dsdneo_tpu.protocol.p25 import encode as E
    from tests.test_fleettrunk_edacs import _edacs_cc_dibits
    from tests.test_fleettrunk_nxdn import _grant_cac_dibits
    secs = 2
    _c, cc_off, vc_off, lpcn, tg, src = DMR_FLEET
    grant = DE.tv_grant_csbk(lpcn=lpcn, ts=0, tg=tg, src=src)
    idle = DE.csbk_bits(25, 0, bytes(8))
    csbks = [grant if i * 144 < 4800 else idle
             for i in range(int(secs * 4800 / 144) + 2)]
    _v, dmr_vc, _b = synth_voice_stream(n_superframes=int(secs / 0.36) + 1,
                                        seed=7)
    t = {"dmr_cc_dibits": DE.cc_stream_dibits(csbks, cc=1),
         "dmr_vc_dibits": np.asarray(dmr_vc, np.uint8),
         "dmr_offs": np.array([cc_off, vc_off], np.int64)}
    _c, cc_off, vc_off, _ch, _tg, _src = NXDN_FLEET
    serial = _read_npz_arrays(OUT_SERIAL)
    t.update(nxdn_cc_dibits=_grant_cac_dibits(int(secs * 2400 / 194) + 2),
             nxdn_vc_dibits=serial["nxdn_dibits"][:secs * 2400 + 192],
             nxdn_offs=np.array([cc_off, vc_off], np.int64))
    _c, cc_off, vc_off, lcn, group, lid = EDACS_FLEET
    msg1 = ((lid >> 7) << 18) | (lcn << 12) | (1 << 11) | group
    msg2 = (lid & 0x7F) << 17
    t.update(edacs_cc_dibits=_edacs_cc_dibits(msg1, msg2,
                                              int(secs * 9600 / 288) + 2),
             edacs_offs=np.array([cc_off, vc_off], np.int64))
    center, cc_off, vc_off, tg_a, tg_b = P2_FLEET
    wacn, sysid = 0x92065, 0x0D5
    iden_tdma = E.iden_up_tdma_tsbk(2, center, 6250.0)
    frames_grant = [E.tsdu_frame(FLEET_NAC, [
        iden_tdma, E.group_grant_tsbk((2 << 12) | (40 + k), tg=tg, src=src),
        _netstat_tsbk()]) for k, (tg, src) in enumerate(((tg_a, 7001),
                                                          (tg_b, 7002)))]
    frame_idle = E.tsdu_frame(FLEET_NAC, [iden_tdma, _netstat_tsbk()])
    rng = np.random.default_rng(0)
    p2_cc = _tsdu_stream(rng, FLEET_NAC, lambda k, at: (
        frames_grant[k % 2] if at < 4800 else frame_idle), secs * 4800)
    _v, p2_vc, _b = synth_p2_voice_stream(
        n_superframes=int(secs / 0.365) + 2, seed=3, wacn=wacn, sysid=sysid,
        nac=FLEET_NAC, sps=8)
    t.update(p2_cc_dibits=p2_cc, p2_vc_dibits=np.asarray(p2_vc, np.uint8),
             p2_offs=np.array([cc_off, vc_off], np.int64))
    return t


def _read_npz_arrays(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _check_fleet(t: dict[str, np.ndarray]) -> None:
    """Each band through the JAX ``TrunkedFleet``: the grants, the
    retargeted row and voice on it."""
    from dsdneo_tpu.engine.fleettrunk import TrunkedFleet
    from dsdneo_tpu.engine.trunk import ChannelMap
    from dsdneo_tpu_torch.engine import fleetvec as FV

    def blocks(wide, fs):
        x = wide.numpy()
        return [x[i:i + int(fs)] for i in range(0, len(x), int(fs))]

    def need(ok, what):
        if not ok:
            raise RuntimeError(f"fleet vector: {what}")

    bb = blocks(FV.bench_band(t), FV.BENCH_FS)
    f = TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF], 4,
                     center_hz=FV.BENCH_CENTER, hangtime_s=5.0,
                     grant_grace_s=0.5, cc_device_pick=True)
    f.step(bb[0])
    pcm = f.step(bb[1])
    need(f.stats.grants == 1 and f.offs[1] == FV.BENCH_VC_OFF
         and np.abs(pcm[0]).mean() > 1e-3 and np.abs(pcm[1:]).max() == 0,
         f"bench cell {f.stats} {f.offs}")
    wb = blocks(FV.wide_band(t), FV.WIDE_FS)
    f = TrunkedFleet(FV.WIDE_FS, t["wide_cc_offs"].tolist(), 16,
                     center_hz=FV.WIDE_CENTER)
    for b in wb:
        f.step(b)
    need(f.stats.grants == 12 and f.stats.releases == 6
         and f.stats.busy_drops == 0 and f.stats.unresolved == 0
         and sorted(c.tg for c in f.calls.values())
         == sorted(t["wide_vc_tgs"][0::2].tolist()),
         f"2.4 MHz cell {f.stats}")
    for mode, spec, fs_off in (("dmr", DMR_FLEET, 3), ("nxdn48", NXDN_FLEET,
                                                       3),
                               ("edacs", EDACS_FLEET, 3)):
        center, cc_off, vc_off, ch = spec[0], spec[1], spec[2], spec[fs_off]
        cm = ChannelMap()
        cm.entries[ch] = center + vc_off
        mb = blocks(FV.BANDS[mode](t), FV.MODE_FS)
        f = TrunkedFleet(FV.MODE_FS, [cc_off], 2, center_hz=center,
                         mode=mode, chan_map=cm)
        f.step(mb[0])
        pcm = f.step(mb[1])
        need(f.stats.grants == 1 and f.offs[1] == vc_off
             and np.abs(pcm[0]).mean() > 1e-3, f"{mode} cell {f.stats}")
    center, cc_off, vc_off = P2_FLEET[:3]
    mb = blocks(FV.p2_band(t), FV.MODE_FS)
    f = TrunkedFleet(FV.MODE_FS, [cc_off], 1, p2_rows=2, center_hz=center)
    f.step(mb[0])
    f.step(mb[1])
    need(f.stats.grants == 2 and f.offs[2] == vc_off
         and (np.abs(f.p2_pcm[:2]).mean(axis=1) > 1e-3).all(),
         f"P2-row cell {f.stats}")


def build_fleet_tables(check: bool = True) -> dict[str, np.ndarray]:
    """The trunked fleet's dibit streams (``engine.fleetvec`` builds the
    bands), each held to the JAX ``TrunkedFleet`` when ``check``."""
    t = {**_bench_fleet_vector(), **_wide_fleet_vector(),
         **_mode_fleet_vectors()}
    if check:
        _check_fleet(t)
    return t


def _write_if_changed(path: str, tables: dict[str, np.ndarray]) -> str:
    """Write ``tables`` to ``path`` unless the file already holds equal
    arrays (an npz of equal arrays still differs in its bytes)."""
    if os.path.exists(path):
        with np.load(path) as z:
            same = sorted(z.files) == sorted(tables) and all(
                z[k].dtype == np.asarray(v).dtype
                and np.array_equal(z[k], v) for k, v in tables.items())
        if same:
            return f"{path}: up to date ({len(tables)} arrays)"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **tables)
    return (f"wrote {path}: {len(tables)} arrays, "
            f"{os.path.getsize(path)} bytes")


def main() -> int:
    tables = build_tables()
    print(_write_if_changed(OUT, tables) + "; false-sync max "
          f"{float(tables['tv_false_sync_max']):.3f}")
    print(_write_if_changed(OUT_DMR, build_dmr_tables()))
    print(_write_if_changed(OUT_TDMA, build_tdma_tables()))
    print(_write_if_changed(OUT_CC, build_cc_tables()))
    print(_write_if_changed(OUT_EVENT, build_event_tables()))
    print(_write_if_changed(OUT_BURST, build_burst_tables()))
    print(_write_if_changed(OUT_SERIAL, build_serial_tables()))
    print(_write_if_changed(OUT_FLEET, build_fleet_tables()))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
