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

The P25 file also holds one test vector: a synthesized P25p1 dibit stream of 16
LDUs (~3 s at 4800 baud) built with protocol.p25.encode, the 88 IMBE
parameter bits of its 144 voice frames, the LDU start positions, and
random lead/tail filler whose sync correlation stays far below the
picker's threshold, so any leading offset the caller cuts from the lead
still yields exactly 16 LDUs.

Run from the repository root, where JAX is installed:

    python tools/export_torch_tables.py

A file whose arrays already equal the rebuilt ones is left untouched.
``tests/test_torch_tables.py`` rebuilds the arrays with ``build_tables``
and ``build_dmr_tables`` and checks them against the checked-in files.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "dsdneo_tpu_torch", "data")
OUT = os.path.join(DATA, "p25p1_tables.npz")
OUT_DMR = os.path.join(DATA, "dmr_tables.npz")
OUT_TDMA = os.path.join(DATA, "tdma_tables.npz")

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
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
