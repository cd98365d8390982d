"""The P25p1 voice slice of the PyTorch port against the JAX pipeline.

A synthesized 8-LDU stream (the test vector in the tables file) on C=2
channels, each with its own leading offset and noise seed, goes through
``dsdneo_tpu.engine.voicebatch.BatchedP25VoicePipeline(2)`` and the
port's pipeline on the CPU, for ``pcm_fmt`` f16 and adpcm:

  - ``frontend_finish``: the candidates whose score clears the 0.62
    threshold have equal position and pattern, score within 1 step,
    and equal NID wherever both decoded the same position (the 512th
    place may differ among near-equal sub-threshold scores);
  - ``pick_ldus`` identical, and the decoded IMBE bits equal the vector's;
  - block 1 from a fresh state, block 2 from the JAX pipeline's carry
    moved across (``params.state_from_numpy``);
  - f16 PCM within 2e-3 of the peak; ADPCM as stated in its test.
"""

import numpy as np
import pytest
import torch

C = 2
B = 72000                   # 1.5 s: 8 whole LDUs per channel
LEADS = (30, 77)
THRESH = 0.62


@pytest.fixture(scope="module")
def tables():
    from dsdneo_tpu_torch import params
    return params.load("cpu")


@pytest.fixture(scope="module")
def blocks(tables):
    from dsdneo_tpu_torch.protocol.p25 import encode
    tv = tables.test_vector()
    return [encode.vector_block(tv, LEADS, seeds, B)
            for seeds in ((101, 202), (303, 404))]


def _jax_state(jp):
    return tuple(None if s is None else tuple(np.asarray(a) for a in s)
                 for s in (jp._dev_pred_state, jp._dev_synth_state,
                           jp._dev_rep_state))


@pytest.fixture(scope="module", params=["f16", "adpcm"])
def runs(request, tables, blocks):
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline as JP
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    fmt = request.param
    jp = JP(C, pcm_fmt=fmt)
    tp = TP(C, pcm_fmt=fmt, device="cpu", tables=tables)
    out = {"fmt": fmt}
    out["jfe"] = jp.frontend_finish(jp.frontend_dispatch(blocks[0]))
    out["tfe"] = tp.frontend_finish(tp.frontend_dispatch(blocks[0]))
    out["jpick"] = jp.pick_ldus(*out["jfe"][1:5], out["jfe"][5],
                                dibits_dev=out["jfe"][0])
    out["tpick"] = tp.pick_ldus(*out["tfe"][1:5], out["tfe"][5],
                                dibits_dev=out["tfe"][0])
    for blk in range(2):
        if blk == 1:
            tp.set_voice_state(*params.state_from_numpy(*_jax_state(jp),
                                                        "cpu"))
        jh = jp.decode_block_async(blocks[blk])
        th = tp.decode_block_async(blocks[blk])
        out["jwire", blk] = np.asarray(jh)
        out["twire", blk] = th.numpy()
        out["jpcm", blk] = jp.fetch_pcm(jh)
        out["tpcm", blk] = tp.fetch_pcm(th)
        out["frames", blk] = tuple(a.numpy() if torch.is_tensor(a) else a
                                   for a in tp.last_frames)
    return out


def test_frontend_finish_matches(runs):
    jd, jidx, jvq, jdq, jmsg, jn = runs["jfe"]
    td, tidx, tvq, tdq, tmsg, tn = runs["tfe"]
    assert jn == tn and tidx.dtype == np.int64 and tmsg.dtype == np.int32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for c in range(C):
        strong = jvq[c] / 127.0 >= THRESH
        assert strong.sum() >= 8
        assert np.array_equal(tidx[c][strong], jidx[c][strong])
        assert np.array_equal(tdq[c][strong], jdq[c][strong])
        assert np.abs(tvq[c][strong].astype(int)
                      - jvq[c][strong].astype(int)).max() <= 1
        k = jmsg.shape[1]
        both = {p: m for p, m in zip(jidx[c][:k], jmsg[c])}
        shared = [(both[p], m) for p, m in zip(tidx[c][:k], tmsg[c])
                  if p in both]
        assert len(shared) >= 8
        assert all(int(a) == int(b) for a, b in shared)


def test_pick_ldus_identical(runs, tables):
    for a, b in zip(runs["jpick"], runs["tpick"]):
        np.testing.assert_array_equal(b, a)
    ac, at, fch, forder = runs["tpick"]
    assert np.array_equal(np.bincount(ac, minlength=C), [8, 8])
    starts = tables.test_vector()["ldu_starts"][:8]
    for c in range(C):
        np.testing.assert_array_equal(at[ac == c], LEADS[c] + starts)


@pytest.mark.parametrize("blk", [0, 1])
def test_decoded_bits_equal_vector(runs, tables, blk):
    bits, errs, fch, forder = runs["frames", blk]
    want = tables.test_vector()["bits88"]
    assert errs.max() == 0
    for c in range(C):
        sel = np.flatnonzero(fch == c)
        got = bits[sel[np.argsort(forder[sel])]]
        np.testing.assert_array_equal(got, want[:len(got)])
        assert len(got) == 72


@pytest.mark.parametrize("blk", [0, 1])
def test_pcm_matches(runs, blk):
    jp, tp = runs["jpcm", blk], runs["tpcm", blk]
    assert tp.shape == jp.shape == (C, 81 * 160)
    assert np.isfinite(tp).all()
    peak = np.abs(jp).max()
    assert peak > 0
    if runs["fmt"] == "f16":
        np.testing.assert_allclose(tp, jp, atol=2e-3 * peak)
        return
    # ADPCM: the encoder is bit-exact (tests/test_torch_audio_wire.py),
    # so the codes can part only where the f16-domain PCM, equal to
    # ~1e-6 of its peak, rounds to another 16-bit level; a parted code
    # moves the decoder by at most one quantizer step until the two
    # streams re-converge.  Ask for 99% equal codes and expanded PCM
    # within 1/8 of the peak.
    jw, tw = runs["jwire", blk], runs["twire", blk]
    assert tw.dtype == np.uint8 and tw.shape == jw.shape
    assert np.mean(tw == jw) >= 0.99
    np.testing.assert_allclose(tp, jp, atol=peak / 8)


def test_reset_voice_state(tables, blocks):
    """reset_voice_state() clears every carry (the next block decodes as
    from a fresh pipeline); reset_voice_state([1]) zeroes only row 1,
    as the JAX pipeline's does."""
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline as JP
    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    a = TP(C, device="cpu", tables=tables)
    a.decode_block(blocks[0])
    a.reset_voice_state()
    assert a.voice_state() == (None, None, None)
    fresh = TP(C, device="cpu", tables=tables).decode_block(blocks[1])
    np.testing.assert_array_equal(a.decode_block(blocks[1]), fresh)

    jp = JP(C)
    jp.decode_block(blocks[0])
    a.reset_voice_state([1])
    jp.reset_voice_state([1])
    for st, jst in zip(a.voice_state(), _jax_state(jp)):
        for t, j in zip(st, jst):
            assert not t[1].any() and np.asarray(j)[1].sum() == 0
            assert t[0].abs().sum() > 0 or not np.asarray(j)[0].any()


def test_nid_second_chance_decode_matches(tables, blocks):
    """The card NID decode for hits outside the top-48 set."""
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline as JP
    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    jp, tp = JP(C), TP(C, device="cpu", tables=tables)
    jd = jp.frontend_finish(jp.frontend_dispatch(blocks[0]))[0]
    td = tp.frontend_finish(tp.frontend_dispatch(blocks[0]))[0]
    rng = np.random.default_rng(0)
    ch = rng.integers(0, C, 70)
    pos = rng.integers(0, 7100, 70)
    pos[:8] = LEADS[0] + tables.test_vector()["ldu_starts"][:8]
    ch[:8] = 0
    want = jp.nid_decode_positions(jd, ch.astype(np.int32),
                                   pos.astype(np.int32))
    got = tp.nid_decode_positions(td, ch, pos)
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert set(int(m) & 0xF for m in got[:8]) == {5, 10}
