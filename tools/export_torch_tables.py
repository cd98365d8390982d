"""Export the constant tables and the test vector of the P25p1 voice
path from the JAX package into ``dsdneo_tpu_torch/data/p25p1_tables.npz``.

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

It also writes one test vector: a synthesized P25p1 dibit stream of 16
LDUs (~3 s at 4800 baud) built with protocol.p25.encode, the 88 IMBE
parameter bits of its 144 voice frames, the LDU start positions, and
random lead/tail filler whose sync correlation stays far below the
picker's threshold, so any leading offset the caller cuts from the lead
still yields exactly 16 LDUs.

Run from the repository root, where JAX is installed:

    python tools/export_torch_tables.py

``tests/test_torch_tables.py`` rebuilds the arrays with ``build_tables``
and checks them against the checked-in file.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "dsdneo_tpu_torch", "data", "p25p1_tables.npz")

TV_NAC = 0x293
TV_N_LDUS = 16
TV_LDU_SEED = 11          # encode.random_voice_ldus seed
TV_FILLER_SEED = 5        # first filler seed tried
TV_LEAD = 256             # lead filler dibits (callers cut a suffix)
TV_TAIL = 640             # tail filler dibits after the last LDU
# largest |sync correlation| allowed anywhere off the true sync starts;
# the pipeline's threshold is 0.62
TV_FALSE_SYNC_MAX = 0.5


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
    from dsdneo_tpu.ops import audio_wire
    from dsdneo_tpu.symbols import framesync
    from dsdneo_tpu.vocoder import glue, imbe, mbe, synth
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
        "adpcm_step": audio_wire.STEP_TABLE.astype(np.int32),
        "adpcm_index": audio_wire.INDEX_TABLE.astype(np.int32),
        # what the JAX synth actually uses: f32 casts of the f64 grid
        "synth_bin_w": synth._BIN_W.astype(np.float32),
        "synth_bin_cos": synth._BIN_COS.astype(np.float32),
        "synth_bin_sin": synth._BIN_SIN.astype(np.float32),
    }
    t.update(_test_vector(sync_levels))
    return t


def main() -> int:
    tables = build_tables()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **tables)
    print(f"wrote {OUT}: {len(tables)} arrays, "
          f"{os.path.getsize(OUT)} bytes; false-sync max "
          f"{float(tables['tv_false_sync_max']):.3f}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
