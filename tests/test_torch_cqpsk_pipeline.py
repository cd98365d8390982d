"""The P25p1 CQPSK voice path of the PyTorch port against the JAX
pipeline: ``BatchedP25VoicePipeline(2, cqpsk=True)`` in both packages on
the CPU.

The input is the port's test vector (4 whole LDUs per block) π/4-DQPSK
modulated by ``protocol.p25.encode.cqpsk_iq`` with a 200 Hz (channel 0)
and a −137 Hz (channel 1) carrier offset, own leading offset and noise
seed per channel.  Compared: the dibits, the candidates that clear the
sync threshold, their NID messages, the accepted LDUs, the decoded IMBE
bits (also against the vector), and the PCM over two consecutive blocks
with each package carrying its own state: f16 within 2e-4 of the peak
(the bound the C4FM path's test states), ADPCM as that test states it.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline as JP
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline as TP
from dsdneo_tpu_torch.protocol.p25 import encode

C = 2
B = 36000                   # 0.75 s: 4 whole LDUs per channel
LEADS = (30, 77)
CFO = (200.0, -137.0)
THRESH = 0.62


@pytest.fixture(scope="module")
def tables():
    return params.load("cpu")


@pytest.fixture(scope="module")
def blocks(tables):
    tv = tables.test_vector()
    return [encode.vector_block(tv, LEADS, seeds, B, modulation="cqpsk",
                                cfo_hz=CFO)
            for seeds in ((11, 22), (33, 44))]


@pytest.fixture(scope="module")
def fronts(tables, blocks):
    jp = JP(C, cqpsk=True)
    tp = TP(C, cqpsk=True, device="cpu", tables=tables)
    return (jp, jp.frontend_sync_device(blocks[0]),
            tp, tp.frontend_sync_device(blocks[0]))


def test_cqpsk_modulator_matches_the_jax_tests_form():
    """``cqpsk_iq`` without noise or offset is the modulator of the JAX
    package's CQPSK tests (an impulse per symbol, RRC-shaped) up to its
    unit-power scale and the placement of the first symbol."""
    from dsdneo_tpu.dsp import firdes
    rng = np.random.default_rng(5)
    dib = rng.integers(0, 4, 400)
    lv = np.array([1, 3, -1, -3])[dib]
    x = np.zeros(4000, np.complex128)
    x[np.arange(400) * 10 + 5] = np.exp(1j * np.cumsum(lv * np.pi / 4.0))
    x = np.convolve(x, firdes.rrc(10.0, 81, 0.2), mode="same")
    got = encode.cqpsk_iq(dib, snr_db=300.0)
    assert got.dtype == np.complex64 and got.shape == (4000,)
    scale = np.sqrt(np.mean(np.abs(x) ** 2))
    np.testing.assert_allclose(got, x / scale, atol=1e-6)
    assert abs(np.mean(np.abs(got) ** 2) - 1.0) < 1e-6


def test_cqpsk_frontend_matches(fronts):
    """Dibits identical; every candidate over the threshold has the same
    position and pattern, a score within one step, and the same NID."""
    _jp, (jd, jidx, jvq, jdq, jmsg, jn), _tp, (td, tidx, tvq, tdq, tmsg,
                                               tn) = fronts
    assert jn == tn == B // 10 - 2
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for c in range(C):
        strong = jvq[c] / 127.0 >= THRESH
        assert strong.sum() >= 4
        assert np.array_equal(tidx[c][strong], jidx[c][strong])
        assert np.array_equal(tdq[c][strong], jdq[c][strong])
        assert np.abs(tvq[c][strong].astype(int)
                      - jvq[c][strong].astype(int)).max() <= 1
        k = jmsg.shape[1]
        both = {p: m for p, m in zip(jidx[c][:k], jmsg[c])}
        shared = [(both[p], m) for p, m in zip(tidx[c][:k], tmsg[c])
                  if p in both]
        assert len(shared) >= 4
        assert all(int(a) == int(b) for a, b in shared)


def test_cqpsk_pick_ldus_identical(fronts, tables):
    """The differential demodulator gives its first symbol up, so every
    sync sits one dibit before its place in the C4FM stream."""
    jp, jfe, tp, tfe = fronts
    jpick = jp.pick_ldus(*jfe[1:5], jfe[5], dibits_dev=jfe[0])
    tpick = tp.pick_ldus(*tfe[1:5], tfe[5], dibits_dev=tfe[0])
    for a, b in zip(jpick, tpick):
        np.testing.assert_array_equal(b, a)
    ac, at, _fch, _forder = tpick
    assert np.array_equal(np.bincount(ac, minlength=C), [4, 4])
    starts = tables.test_vector()["ldu_starts"][:4]
    for c in range(C):
        np.testing.assert_array_equal(at[ac == c], LEADS[c] - 1 + starts)


@pytest.mark.parametrize("fmt", ["f16", "adpcm"])
def test_cqpsk_two_blocks_match(tables, blocks, fmt):
    """Two consecutive blocks, each package carrying its own state: the
    IMBE bits equal the vector's, the theta carry is bit-equal, f16 PCM
    within 2e-4 of the peak; ADPCM: 99% equal codes and expanded PCM
    within 1/8 of the peak (a parted code moves the decoder by at most
    one quantizer step until the streams re-converge)."""
    jp = JP(C, cqpsk=True, pcm_fmt=fmt)
    tp = TP(C, cqpsk=True, pcm_fmt=fmt, device="cpu", tables=tables)
    want_bits = tables.test_vector()["bits88"][:36]
    for blk in range(2):
        jh = jp.decode_block_async(blocks[blk])
        th = tp.decode_block_async(blocks[blk])
        bits, errs, fch, forder = tp.last_frames
        assert int(errs.max()) == 0
        for c in range(C):
            sel = np.flatnonzero(fch == c)
            got = bits.numpy()[sel[np.argsort(forder[sel])]]
            np.testing.assert_array_equal(got, want_bits)
        jpcm, tpcm = jp.fetch_pcm(jh), tp.fetch_pcm(th)
        peak = np.abs(jpcm).max()
        assert tpcm.shape == jpcm.shape == (C, 54 * 160) and peak > 0
        np.testing.assert_array_equal(
            tp.voice_state()[1][0].numpy(),
            np.asarray(jp._dev_synth_state[0]))               # theta
        if fmt == "f16":
            np.testing.assert_allclose(tpcm, jpcm, atol=2e-4 * peak)
        else:
            assert np.mean(th.numpy() == np.asarray(jh)) >= 0.99
            np.testing.assert_allclose(tpcm, jpcm, atol=peak / 8)


def test_cqpsk_carry_moves_across(tables, blocks):
    """Block 1 in the JAX pipeline, its three carries moved into the port
    (``params.state_from_numpy``), block 2 in both: f16 PCM within 2e-4
    of the peak."""
    jp = JP(C, cqpsk=True)
    tp = TP(C, cqpsk=True, device="cpu", tables=tables)
    jp.decode_block(blocks[0])
    state = tuple(tuple(np.asarray(a) for a in s)
                  for s in (jp._dev_pred_state, jp._dev_synth_state,
                            jp._dev_rep_state))
    tp.set_voice_state(*params.state_from_numpy(*state, "cpu"))
    jpcm, tpcm = jp.decode_block(blocks[1]), tp.decode_block(blocks[1])
    np.testing.assert_allclose(tpcm, jpcm, atol=2e-4 * np.abs(jpcm).max())


def test_cqpsk_pipeline_defaults_to_the_card(tables):
    if torch.cuda.is_available():
        assert TP(C, cqpsk=True).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP(C, cqpsk=True)
