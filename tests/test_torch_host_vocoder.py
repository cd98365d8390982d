"""The host IMBE vocoder of the PyTorch port against the JAX package's
(``vocoder/imbe.py``, ``vocoder/mbe.py``, ``vocoder/glue.py``,
``vocoder/synth.synthesize_frames``), on the CPU, inputs from seeded
numpy generators:

  - ``imbe.decode_frame`` on 1,000 random 88-bit strings (chained
    through ``prev``) and ``encode_frame`` on 300 random parameter sets:
    every field equal, the log amplitudes bit for bit (both are numpy);
  - ``mbe.decode_imbe_4400`` and ``decode_ambe_2450`` on random frames:
    ω0, L, voicing and amplitudes equal bit for bit; ``frames_to_arrays``
    equal;
  - ``MbeGlue``, the scenarios of ``tests/test_mbe_glue.py`` (tone
    frames, the tone phase across frames, the repeat budget then
    silence, silence before any good frame, the error ring, the IMBE and
    AMBE tone detectors): every directive equal, and the rendered PCM
    equal to the JAX package's within 1e-5 of full scale (tones and
    silence are numpy in both; the voice frames go through the
    synthesizer);
  - ``synthesize_frames`` on 40 random frames: the PCM within 2e-3 of
    the peak of the JAX package's (the bound the voice paths hold
    their PCM to: the port's float32 harmonic sum runs in another order
    than XLA's).

The JAX synthesizer is jitted, as the JAX package calls it.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.vocoder import glue as jglue  # noqa: E402
from dsdneo_tpu.vocoder import imbe as jimbe  # noqa: E402
from dsdneo_tpu.vocoder import mbe as jmbe  # noqa: E402
from dsdneo_tpu.vocoder import synth as jsynth  # noqa: E402
from dsdneo_tpu_torch.vocoder import glue as tglue  # noqa: E402
from dsdneo_tpu_torch.vocoder import imbe as timbe  # noqa: E402
from dsdneo_tpu_torch.vocoder import mbe as tmbe  # noqa: E402
from dsdneo_tpu_torch.vocoder import synth as tsynth  # noqa: E402

PCM_REL = 2e-3           # synthesized PCM, as a fraction of the peak
TONE_ABS = 1e-5          # tones and silence (numpy in both packages)


def _params_equal(a, b):
    assert (a.b0, a.L, a.K, a.gain_code) == (b.b0, b.L, b.K, b.gain_code)
    assert a.w0 == b.w0
    np.testing.assert_array_equal(a.voiced_bands, b.voiced_bands)
    np.testing.assert_array_equal(a.log_m, b.log_m)


def _frame_equal(a, b):
    assert (a.w0, a.L) == (b.w0, b.L)
    np.testing.assert_array_equal(a.voiced, b.voiced)
    np.testing.assert_array_equal(a.amps, b.amps)


def test_tables_equal():
    assert (timbe.MAX_L, timbe.PRED_DECAY, timbe.GAIN_STEP, timbe.GAIN_MIN,
            timbe.QUANT_SPAN) == (jimbe.MAX_L, jimbe.PRED_DECAY,
                                  jimbe.GAIN_STEP, jimbe.GAIN_MIN,
                                  jimbe.QUANT_SPAN)
    for L in range(9, 57):
        for K in range(1, 13):
            assert timbe.bit_allocation(L, K) == jimbe.bit_allocation(L, K)
        assert timbe.block_lengths(L) == jimbe.block_lengths(L)
    for b0 in range(256):
        assert timbe.harmonics_for_b0(b0) == jimbe.harmonics_for_b0(b0)


def test_decode_frame_random_strings():
    rng = np.random.default_rng(1)
    jp = tp = None
    for _ in range(1000):
        s = rng.integers(0, 2, 88).astype(np.uint8)
        a, b = jimbe.decode_frame(s, jp), timbe.decode_frame(s, tp)
        _params_equal(a, b)
        jp, tp = a, b


def test_encode_frame_random_params():
    rng = np.random.default_rng(2)
    prev = None
    for _ in range(300):
        b0 = int(rng.integers(0, 208))
        w0, L, K = jimbe.harmonics_for_b0(b0)
        kw = dict(b0=b0, w0=w0, L=L, K=K,
                  voiced_bands=rng.integers(0, 2, K).astype(np.uint8),
                  log_m=rng.uniform(-1.0, 6.0, size=L),
                  gain_code=int(rng.integers(0, 64)))
        sync = int(rng.integers(0, 2))
        a = jimbe.encode_frame(jimbe.ImbeParams(**kw), prev, sync=sync)
        tprev = None if prev is None else timbe.ImbeParams(
            **{k: getattr(prev, k) for k in kw})
        b = timbe.encode_frame(timbe.ImbeParams(**kw), tprev, sync=sync)
        np.testing.assert_array_equal(a, b)
        prev = jimbe.ImbeParams(**kw)


def test_decode_imbe_4400_and_ambe_2450():
    rng = np.random.default_rng(3)
    jp = tp = None
    jf, tf = [], []
    for _ in range(400):
        s = rng.integers(0, 2, 88).astype(np.uint8)
        a, b = jmbe.decode_imbe_4400(s, prev=jp), tmbe.decode_imbe_4400(
            s, prev=tp)
        _frame_equal(a, b)
        jp, tp = a, b
        jf.append(a)
        tf.append(b)
    for _ in range(400):
        s = rng.integers(0, 2, 49).astype(np.uint8)
        _frame_equal(jmbe.decode_ambe_2450(s), tmbe.decode_ambe_2450(s))
    for x, y in zip(jmbe.frames_to_arrays(jf), tmbe.frames_to_arrays(tf)):
        np.testing.assert_array_equal(x, y)


def _voice_frame(mbe, imbe, seed=0):
    """``tests/test_mbe_glue.py``'s ``_mk_frame``: random bits with a
    voice-range b0 (100)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 88).astype(np.uint8)
    for i, p in enumerate(imbe.B0_HI_POS):
        bits[p] = (100 >> (7 - i)) & 1
    bits[imbe.B0_LO_POS[0]] = 0
    bits[imbe.B0_LO_POS[1]] = 0
    return mbe.decode_imbe_4400(bits)


def _glue_scenario(glue, mbe, imbe, render):
    """The directive sequence of the glue tests, rendered; returns
    (directive kinds and tone args, PCM, accounting)."""
    out, pcm = [], []
    g = glue.MbeGlue()
    d = g.condition(None, 0, (32, 50))                       # tone frame
    out.append(d)
    pcm.append(render(g, [d, d]))                            # phase carry
    g = glue.MbeGlue()
    good = _voice_frame(mbe, imbe)
    seq = [g.condition(good, 2, None)]
    seq += [g.condition(None, 9, None) for _ in range(5)]    # repeat, mute
    seq += [g.condition(good, 0, None), g.condition(None, 9, None)]
    out += [(k, a if k == "tone" else None) for k, a in seq]
    pcm.append(render(g, seq))
    g2 = glue.MbeGlue()
    out.append(g2.condition(None, 99, None))                 # no good yet
    g3 = glue.MbeGlue(hist_len=5)
    for e in (1, 2, 3, 4, 5, 6):
        g3.account(e)
    acc = (list(g3.err_hist), g3.err_avg(), g3.total_errs, g.muted_frames,
           g.tone_frames, g.repeat, g.err_avg())
    pcm.append(glue.synthesize_tone(32, 50, 160)[0])
    return out, pcm, acc


def test_mbe_glue_scenarios():
    jout, jpcm, jacc = _glue_scenario(
        jglue, jmbe, jimbe, lambda g, d: g.render(d))
    tout, tpcm, tacc = _glue_scenario(
        tglue, tmbe, timbe, lambda g, d: g.render(d, "cpu"))
    assert [k for k, _ in jout] == [k for k, _ in tout] == [
        "tone", "voice", "repeat", "repeat", "repeat", "silence", "silence",
        "voice", "repeat", "silence"]
    assert [a for k, a in jout if k == "tone"] == [
        a for k, a in tout if k == "tone"]
    assert jacc == tacc
    # the tone frames and the silence are numpy in both packages
    np.testing.assert_allclose(tpcm[0], jpcm[0], atol=TONE_ABS)
    np.testing.assert_allclose(tpcm[2], jpcm[2], atol=TONE_ABS)
    a, b = jpcm[1], tpcm[1]
    assert a.shape == b.shape == (8 * 160,)
    np.testing.assert_array_equal(a[4 * 160:6 * 160], 0.0)
    np.testing.assert_array_equal(b[4 * 160:6 * 160], 0.0)
    assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()


def test_tone_detectors():
    rng = np.random.default_rng(4)
    for _ in range(2000):
        bits = rng.integers(0, 2, 88).astype(np.uint8)
        b0 = int(rng.integers(200, 256))
        for i, p in enumerate(jimbe.B0_HI_POS):
            bits[p] = (b0 >> (7 - i)) & 1
        if rng.integers(0, 2):
            bits[19:26] = bits[12:19]        # the ID repeated
        assert jglue.imbe_tone_info(bits) == tglue.imbe_tone_info(bits)
        assert jglue.imbe_raw_b0(bits) == tglue.imbe_raw_b0(bits)
        b49 = rng.integers(0, 2, 49).astype(np.uint8)
        if rng.integers(0, 2):
            b49[:7] = 1
            b49[21:28] = b49[7:14]
        assert jglue.ambe_tone_info(b49) == tglue.ambe_tone_info(b49)


def test_synthesize_frames():
    rng = np.random.default_rng(5)
    frames_j, frames_t = [], []
    jp = tp = None
    for _ in range(40):
        s = rng.integers(0, 2, 88).astype(np.uint8)
        s[jimbe.B0_HI_POS[0]] = 0            # b0 < 128: voice
        jp = jmbe.decode_imbe_4400(s, prev=jp)
        tp = tmbe.decode_imbe_4400(s, prev=tp)
        frames_j.append(jp)
        frames_t.append(tp)
    a = jsynth.synthesize_frames(frames_j)
    b = tsynth.synthesize_frames(frames_t, "cpu")
    assert a.shape == b.shape == (40 * 160,) and b.dtype == np.float32
    assert np.isfinite(b).all() and np.abs(b).max() > 0.01
    assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
    assert tsynth.synthesize_frames([], "cpu").shape == (0,)


def test_synthesize_frames_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fr = _voice_frame(tmbe, timbe)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsynth.synthesize_frames([fr])
