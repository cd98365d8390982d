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
    moved across (``params.state_from_numpy``), and both blocks run
    wholly in each package with no state carried across;
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


@pytest.mark.parametrize("fmt", ["f16", "adpcm"])
def test_two_blocks_wholly_in_the_port(tables, blocks, fmt):
    """Two consecutive blocks, each package carrying its own state: the
    port's theta carry is summed in XLA's order (vocoder.synth.tree_sum)
    and its ω interpolation rounded as XLA's fused multiply-add, so the
    second block stays as close to the JAX pipeline as the first.  f16
    PCM within 2e-4 of the peak (block 0 measures ~1.3e-4); the carries
    after each block equal; ADPCM: 99% equal codes and expanded PCM
    within 1/8 of the peak, as in ``test_pcm_matches``."""
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline as JP
    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    jp = JP(C, pcm_fmt=fmt)
    tp = TP(C, pcm_fmt=fmt, device="cpu", tables=tables)
    for blk in range(2):
        jh = jp.decode_block_async(blocks[blk])
        th = tp.decode_block_async(blocks[blk])
        jpcm, tpcm = jp.fetch_pcm(jh), tp.fetch_pcm(th)
        peak = np.abs(jpcm).max()
        assert tpcm.shape == jpcm.shape and peak > 0
        js, ts = _jax_state(jp)[1], tp.voice_state()[1]
        np.testing.assert_array_equal(ts[0].numpy(), js[0])    # theta
        if fmt == "f16":
            np.testing.assert_allclose(tpcm, jpcm, atol=2e-4 * peak)
        else:
            assert np.mean(th.numpy() == np.asarray(jh)) >= 0.99
            np.testing.assert_allclose(tpcm, jpcm, atol=peak / 8)


def test_pipeline_defaults_to_the_card(tables):
    """``BatchedP25VoicePipeline(C)`` with no device runs on the card and
    raises where there is none."""
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    if torch.cuda.is_available():
        assert BatchedP25VoicePipeline(C).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedP25VoicePipeline(C)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedP25VoicePipeline(C, tables=tables)


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


# -- stream-ordered hand-offs ------------------------------------------------
HAND_LEADS = (30, 77, 5, 140)
HAND_B = 72000


def _hand_blocks(tv):
    from dsdneo_tpu_torch.protocol.p25 import encode
    return [encode.vector_block(tv, HAND_LEADS, (11 + k, 12 + k, 13 + k,
                                                 14 + k), HAND_B)
            for k in range(0, 40, 10)]


def _pipelined(pipe, blocks):
    """``portbench/entries/p25_pipelined.py``'s order: block N+1
    dispatched before block N's candidates are fetched, block N−1's PCM
    fetched after block N's decode is queued.  Returns each block's PCM,
    a copy of each block's decoded frames (taken on the device) and the
    first block's ``frontend_finish`` result with a copy of its arrays."""
    pcm, frames = [], []
    fe = pipe.frontend_dispatch(blocks[0])
    prev = held = None
    for i in range(len(blocks)):
        nxt = (pipe.frontend_dispatch(blocks[i + 1])
               if i + 1 < len(blocks) else None)
        f = pipe.frontend_finish(fe)
        if held is None:
            held = (f, [np.array(a) for a in f[1:5]])
        h = pipe.decode_from_frontend(f)
        lf = pipe.last_frames
        frames.append((lf[0].clone(), lf[1].clone(), lf[2], lf[3]))
        if prev is not None:
            pcm.append(pipe.fetch_pcm(prev))
        prev, fe = h, nxt
    pcm.append(pipe.fetch_pcm(prev))
    return pcm, frames, held


def _same_as_sequential(make, blocks, pcm, frames, held):
    """Bit for bit what sequential ``decode_block`` calls give: the PCM,
    every block's frames, the carries after the last block; and the held
    candidates unchanged by the blocks after them."""
    seq = make()
    for k, b in enumerate(blocks):
        np.testing.assert_array_equal(pcm[k], seq.decode_block(b))
        lf = seq.last_frames
        assert torch.equal(frames[k][0].cpu(), lf[0].cpu())
        assert torch.equal(frames[k][1].cpu(), lf[1].cpu())
        np.testing.assert_array_equal(frames[k][2], lf[2])
        np.testing.assert_array_equal(frames[k][3], lf[3])
    return seq


def _carries_equal(a, b):
    for pa, pb in zip(a.voice_state(), b.voice_state()):
        for ta, tb in zip(pa, pb):
            assert torch.equal(ta.cpu(), tb.cpu())


def test_pipelined_order_matches_sequential_on_cpu(tables):
    """On the CPU device the benchmark's pipelined order gives the PCM,
    frames and carries of sequential ``decode_block`` calls; every hand-off
    of a pageable numpy block takes the blocking path (the block in, the
    candidates and the PCM out: 3 a block), and each result handed to the
    host (2 a block) counts as waited for; a held ``frontend_finish``
    result stays as it was."""
    from torch.profiler import ProfilerActivity, profile

    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    from dsdneo_tpu_torch.runtime import trace
    blocks = _hand_blocks(tables.test_vector())

    def make():
        return TP(4, pcm_fmt="f16", device="cpu", tables=tables)

    pipe = make()
    with profile(activities=[ProfilerActivity.CPU]):
        pcm, frames, held = _pipelined(pipe, blocks)
    s = trace.last_session()
    assert s.total("p25.blocking_handoffs") == 3 * len(blocks)
    assert s.total("p25.handoffs") == s.total("p25.handoff_waited") \
        == 2 * len(blocks)
    assert s.total("p25.nid_roundtrips") == 0
    seq = _same_as_sequential(make, blocks, pcm, frames, held)
    _carries_equal(pipe, seq)
    for a, b in zip(held[0][1:5], held[1]):
        np.testing.assert_array_equal(a, b)
    assert held[0][1].dtype == np.int64 and held[0][4].dtype == np.int32


@pytest.mark.cuda
def test_handoffs_on_the_card_do_not_synchronize():
    """On the card, with a pinned block: ``frontend_dispatch`` and, for a
    pick whose hits all fall in the top ``NID_TOPK``,
    ``decode_from_frontend`` make no synchronizing call
    (``torch.cuda.set_sync_debug_mode("error")``).  Four pinned blocks in
    the benchmark's pipelined order give the PCM, frames and carries of
    sequential ``decode_block`` calls bit for bit, take every hand-off the
    stream-ordered way (candidates and PCM: 2 a block) and none the
    blocking way, and leave a held ``frontend_finish`` result as it
    was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    from dsdneo_tpu_torch.runtime import trace
    dev = torch.device("cuda", 0)
    card = params.load(dev)
    blocks = [torch.from_numpy(b).pin_memory()
              for b in _hand_blocks(card.test_vector())]

    def make():
        return TP(4, pcm_fmt="adpcm", device=dev, tables=card)

    make().decode_block(blocks[0])        # builds the kernels, constants
    torch.cuda.synchronize()
    pipe = make()
    roundtrips = []
    nid = pipe.nid_decode_positions
    pipe.nid_decode_positions = lambda d, ch, pos: (
        roundtrips.append(len(ch)), nid(d, ch, pos))[1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        fe = pipe.frontend_dispatch(blocks[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    f = pipe.frontend_finish(fe)
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = pipe.decode_from_frontend(f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert roundtrips == []
    assert pipe.fetch_pcm(h).shape[1] > 0

    pipe = make()
    with profile(activities=[ProfilerActivity.CPU]):
        pcm, frames, held = _pipelined(pipe, blocks)
    s = trace.last_session()
    assert s.total("p25.blocking_handoffs") == 0
    assert s.total("p25.handoffs") == 2 * len(blocks)
    seq = _same_as_sequential(make, blocks, pcm, frames, held)
    _carries_equal(pipe, seq)
    for a, b in zip(held[0][1:5], held[1]):
        np.testing.assert_array_equal(a, b)
