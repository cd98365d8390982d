"""The X2-TDMA two-slot voice path of the PyTorch port against the JAX
pipeline: ``BatchedX2VoicePipeline(2)`` in both packages on the CPU.

The input is the port's X2 test vector (the JAX package's
``synth_x2_voice_stream(8, seed=1)``, the bench's stream), cut to blocks
of 3 superframes per slot, modulated as the JAX generator modulates it,
with its own leading offset and noise seed per channel.  Compared: the
dibits, the candidates (position, score, pattern; the EMB column is
zero), the accepted superframes, the AMBE bits and error counts, the
wire bytes and the PCM over two blocks with each package carrying its
own state, and a JAX carry handed to the port.

PCM bounds, as the DMR path is held.  f16: 2e-4 of the peak plus one
float16 step (the synthesized PCM agrees to ~1e-6, not to the bit).
µ-law and ADPCM: the encoders are bit-exact, so a byte can part only
where that PCM sits on a level boundary (1 byte in 34,560 of these
blocks); at least 99.9% (µ-law) and 99% (ADPCM) of the bytes are equal
and the expanded PCM stays within one companding step (5% of the value
+ 1e-3) and an eighth of the peak.

The candidates are compared as sets: the soft symbols of the two
packages agree to ~1e-5, not to the bit, so two candidates whose scores
tie in one package may be ordered the other way in the other.  The
picker sorts them by position, so the picks do not depend on it.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")     # the card's machine has none

from dsdneo_tpu.engine import dmrbatch as jdmr
from dsdneo_tpu.engine import x2batch as jx2
from dsdneo_tpu.fec import device as jfec
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine import x2batch as tx2
from dsdneo_tpu_torch.protocol.dmr import encode
from dsdneo_tpu_torch.protocol.p25.encode import tdma_fm_iq

C = 2
B = 43200                   # 0.9 s: 3 superframes on each slot
LEADS = ((7, 40), (0, 25))  # per block, per channel
SEEDS = ((1, 2), (3, 4))


@pytest.fixture(scope="module")
def tables():
    return params.load_tdma("x2tdma", "cpu")


@pytest.fixture(scope="module")
def blocks(tables):
    tv = tables.test_vector()
    return [encode.vector_block(tv, LEADS[i], SEEDS[i], B, sps=8,
                                modulate=tdma_fm_iq) for i in range(2)]


def sorted_candidates(fe):
    """Per channel, the candidate columns ordered by position."""
    idx = np.asarray(fe[1])
    order = np.argsort(idx, axis=1, kind="stable")
    out = []
    for a in fe[1:5]:
        a = np.asarray(a)
        o = order.reshape(order.shape + (1,) * (a.ndim - 2))
        out.append(np.take_along_axis(a, o, axis=1))
    return out


def jax_frames(jfe, picks):
    """The JAX side's decoded frames: its dibits gathered at its accepted
    superframes and run through its AMBE ECC, as its device program does
    (it returns only the PCM)."""
    dib = np.asarray(jfe[0])
    ac, at, ai = picks[:3]
    offs = jdmr._sf_frame_offsets()
    dd = np.stack([dib[c][np.clip(int(t) + offs, 0, dib.shape[1] - 1)]
                   ^ (2 * int(i)) for c, t, i in zip(ac, at, ai)])
    dd = dd.reshape(-1, 36)
    b72 = np.zeros((dd.shape[0], 72), np.uint8)
    b72[:, 0::2] = (dd >> 1) & 1
    b72[:, 1::2] = dd & 1
    return tuple(np.asarray(a) for a in jfec.ambe_ecc_batch(b72))


def test_x2_tables_and_modulator(tables):
    """The x2tdma tables are the JAX pipeline's front end; the vector is
    the bench's stream; the modulator is the JAX generator's."""
    jp = jx2.BatchedX2VoicePipeline(1)
    np.testing.assert_array_equal(tables.taps.numpy(), jp.taps)
    assert tables.symbol_rate == 6000.0 and jp.sps == 8.0
    assert tables.sync_inverted == (False, False)
    assert tx2.BatchedX2VoicePipeline.SYNC_NAMES == jp.SYNC_NAMES
    iq, dib, bits49 = jx2.synth_x2_voice_stream(n_superframes=8, seed=1)
    tv = tables.test_vector()
    np.testing.assert_array_equal(tv["dibits"], dib)
    np.testing.assert_array_equal(tv["bits49"], bits49)
    np.testing.assert_array_equal(tdma_fm_iq(dib).astype(np.complex64), iq)


@pytest.fixture(scope="module")
def fronts(tables, blocks):
    jp = jx2.BatchedX2VoicePipeline(C)
    tp = tx2.BatchedX2VoicePipeline(C, device="cpu", tables=tables)
    return (jp, jp.frontend_sync_device(blocks[0]),
            tp, tp.frontend_sync_device(blocks[0]))


def test_x2_frontend_candidates_equal(fronts):
    _jp, jfe, _tp, tfe = fronts
    assert jfe[5] == tfe[5] == B // 8 - 2
    np.testing.assert_array_equal(tfe[0].numpy(), np.asarray(jfe[0]))
    assert tfe[1].shape == (C, 128) and not tfe[4].any()
    for name, a, b in zip(("idx", "vq", "dq", "eq"), sorted_candidates(tfe),
                          sorted_candidates(jfe)):
        np.testing.assert_array_equal(a, b, name)


def test_x2_pick_superframes_identical(fronts, tables):
    jp, jfe, tp, tfe = fronts
    tpick = tp.pick_superframes(*tfe[1:])
    for a, b in zip(tpick, jp.pick_superframes(*jfe[1:])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ac, at, ai, _fch, _forder = tpick
    assert not ai.any()
    tv = tables.test_vector()
    for c in range(C):
        pos, _bits = encode.expected_frames(tv, LEADS[0][c], tfe[5])
        assert len(pos) == 6
        np.testing.assert_array_equal(at[ac == c], pos)


@pytest.fixture(scope="module", params=["f16", "mulaw", "adpcm"])
def runs(request, tables, blocks):
    """Two blocks with the carry kept, in both pipelines."""
    fmt = request.param
    jp = jx2.BatchedX2VoicePipeline(C, pcm_fmt=fmt)
    tp = tx2.BatchedX2VoicePipeline(C, pcm_fmt=fmt, device="cpu",
                                    tables=tables)
    out = {"fmt": fmt}
    for blk in range(2):
        jfe = jp.frontend_sync_device(blocks[blk])
        jh = jp.decode_from_frontend(jfe)
        th = tp.decode_block_async(blocks[blk])
        out["jframes", blk] = jax_frames(jfe, jp.pick_superframes(*jfe[1:]))
        out["tframes", blk] = tuple(a.numpy() if torch.is_tensor(a) else a
                                    for a in tp.last_frames)
        out["jwire", blk], out["twire", blk] = np.asarray(jh), th.numpy()
        out["jpcm", blk], out["tpcm", blk] = (jp.fetch_pcm(jh),
                                              tp.fetch_pcm(th))
        out["jstate", blk], out["tstate", blk] = jp._vstate, tp._vstate
    return out


@pytest.mark.parametrize("blk", [0, 1])
def test_x2_bits49_and_error_counts_identical(runs, tables, blk):
    jbits, jerrs = runs["jframes", blk]
    tbits, terrs, fch, _forder = runs["tframes", blk]
    assert tbits.shape == (C * 6 * 18, 49)
    np.testing.assert_array_equal(tbits, jbits)
    np.testing.assert_array_equal(terrs, jerrs)
    tv = tables.test_vector()
    for c in range(C):
        _pos, want = encode.expected_frames(tv, LEADS[blk][c], B // 8 - 2)
        got = tbits[fch == c].reshape(6, 18, 49)
        assert (got == want).all(-1).mean() > 0.9


def assert_pcm_matches(fmt, tp, jp, tw, jw):
    """The PCM bounds of this file's docstring."""
    assert tw.shape == jw.shape and tw.dtype == jw.dtype
    peak = np.abs(jp).max()
    assert 0 < peak <= 1.0 + 1e-4 and np.isfinite(tp).all()
    if fmt == "f16":
        np.testing.assert_allclose(tp, jp, atol=2e-4 * peak,
                                   rtol=2.0 ** -10)
    elif fmt == "mulaw":
        assert np.mean(tw == jw) >= 0.999
        assert (np.abs(tp - jp) <= 0.05 * np.abs(jp) + 1e-3).all()
    else:
        assert np.mean(tw == jw) >= 0.99
        np.testing.assert_allclose(tp, jp, atol=peak / 8)


@pytest.mark.parametrize("blk", [0, 1])
def test_x2_pcm_and_carries_match(runs, blk):
    jp, tp = runs["jpcm", blk], runs["tpcm", blk]
    assert tp.shape == jp.shape == (C, 108 * 160)
    assert_pcm_matches(runs["fmt"], tp, jp, runs["twire", blk],
                       runs["jwire", blk])
    flat = lambda st: [a.numpy() if torch.is_tensor(a) else np.asarray(a)
                       for part in st for a in part]
    for i, (a, b) in enumerate(zip(flat(runs["tstate", blk]),
                                   flat(runs["jstate", blk]))):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=str(i))


def test_x2_state_moves_across(tables, blocks):
    """A JAX carry handed to the port continues the second block as the
    JAX pipeline does."""
    jp = jx2.BatchedX2VoicePipeline(C)
    tp = tx2.BatchedX2VoicePipeline(C, device="cpu", tables=tables)
    jp.decode_block(blocks[0])
    synth, rep = (tuple(np.asarray(a) for a in part) for part in jp._vstate)
    tp._vstate = params.state_from_numpy(None, synth, rep, "cpu")[1:]
    jpcm, tpcm = jp.decode_block(blocks[1]), tp.decode_block(blocks[1])
    np.testing.assert_allclose(tpcm, jpcm, atol=2e-4 * np.abs(jpcm).max(),
                               rtol=2.0 ** -10)


def test_x2_entry_point_defaults_to_the_card(tables):
    if torch.cuda.is_available():
        assert tx2.BatchedX2VoicePipeline(C).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tx2.BatchedX2VoicePipeline(C)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params.load_tdma("x2tdma")
