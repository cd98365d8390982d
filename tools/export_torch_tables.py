"""Export the constant tables and the test vectors of the ported voice
paths from the JAX package into ``dsdneo_tpu_torch/data/``:
``p25p1_tables.npz`` (P25 Phase 1, C4FM and CQPSK) and ``dmr_tables.npz``
(DMR BS two-slot voice and the AMBE core).

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
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
