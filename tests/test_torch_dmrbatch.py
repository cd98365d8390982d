"""The DMR BS two-slot voice path of the PyTorch port against the JAX
pipeline: ``BatchedDmrVoicePipeline(2)`` in both packages on the CPU.

The input is the port's DMR test vector (the JAX package's
``synth_voice_stream(8, seed=1)``), cut to blocks of 3 superframes per
slot, FM-modulated with its own leading offset and noise seed per
channel.  Compared: the dibits, every candidate (position, score,
pattern, EMB error count), the accepted superframes, the decoded AMBE
bits and error counts, and the PCM over two consecutive blocks with each
package carrying its own state, with one row reset in between.

PCM bounds.  f16: 2e-4 of the peak plus one float16 step (the wire value
is a float16 of PCM that agrees to ~1e-6).  µ-law and ADPCM: the
encoders are bit-exact, so a byte can part only where that PCM rounds to
another level; at least 99.9% (µ-law) and 99% (ADPCM) of the bytes are
equal and the expanded PCM stays within one companding step (5% of the
value + 1e-3) and an eighth of the peak.

The hand-offs and the tracer need no JAX: the pipelined order against
sequential calls, the spans and counters (``dmr.*``, and ``x2.*`` for
X2-TDMA), and on the card (``-m cuda``) a pinned block's dispatch and
decode under ``torch.cuda.set_sync_debug_mode("error")``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

try:
    from dsdneo_tpu.engine import dmrbatch as jdmr
    from dsdneo_tpu.fec import device as jfec
except ImportError:         # the card's machine has no JAX
    jdmr = jfec = None
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine import dmrbatch as tdmr
from dsdneo_tpu_torch.protocol.dmr import encode
from dsdneo_tpu_torch.runtime import trace

needs_jax = pytest.mark.skipif(jdmr is None, reason="needs the JAX package "
                               "(the reference), absent on the card's "
                               "machine")
C = 2
B = 54000                   # 1.125 s: 3 superframes on each slot
LEADS = ((7, 40), (0, 25))  # per block, per channel
SEEDS = ((1, 2), (3, 4))


@pytest.fixture(scope="module")
def tables():
    return params.load_dmr("cpu")


@pytest.fixture(scope="module")
def blocks(tables):
    tv = tables.test_vector()
    return [encode.vector_block(tv, LEADS[i], SEEDS[i], B) for i in range(2)]


def _jax_frames(jfe, picks):
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


@pytest.fixture(scope="module")
def fronts(tables, blocks):
    jp = jdmr.BatchedDmrVoicePipeline(C)
    tp = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    return (jp, jp.frontend_sync_device(blocks[0]),
            tp, tp.frontend_sync_device(blocks[0]))


@needs_jax
def test_sf_frame_offsets_and_modulator(tables):
    np.testing.assert_array_equal(tdmr._sf_frame_offsets(),
                                  jdmr._sf_frame_offsets())
    assert (tdmr.SF_PERIOD, tdmr.SF_EXTENT) == (jdmr.SF_PERIOD,
                                                jdmr.SF_EXTENT)
    iq, dib, bits49 = jdmr.synth_voice_stream(n_superframes=2, seed=4)
    np.testing.assert_array_equal(encode.dmr_fm_iq(dib), iq)


@needs_jax
def test_dmr_frontend_candidates_identical(fronts):
    """Every one of the 128 candidates per channel: position, quantized
    score, pattern and EMB error count.  The scores are float32 sums
    taken in the same order; the EMB counts are distances to the ML
    codeword, which do not depend on which of two tied codewords the
    argmax took."""
    _jp, jfe, _tp, tfe = fronts
    assert jfe[5] == tfe[5] == B // 10 - 2
    np.testing.assert_array_equal(tfe[0].numpy(), np.asarray(jfe[0]))
    for name, a, b in zip(("idx", "vq", "dq", "eq"), tfe[1:5], jfe[1:5]):
        assert a.shape == (C, 128), name
        np.testing.assert_array_equal(a, b, name)
    assert tfe[1].dtype == np.int64 and tfe[4].dtype == np.uint8


@needs_jax
def test_dmr_pick_superframes_identical(fronts, tables):
    jp, jfe, tp, tfe = fronts
    jpick = jp.pick_superframes(*jfe[1:])
    tpick = tp.pick_superframes(*tfe[1:])
    for a, b in zip(tpick, jpick):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ac, at, ai, fch, forder = tpick
    assert not ai.any()
    tv = tables.test_vector()
    for c in range(C):
        pos, _bits = encode.expected_frames(tv, LEADS[0][c], tfe[5])
        assert len(pos) == 6
        np.testing.assert_array_equal(at[ac == c], pos)
    # only pad frames may share a (channel, step) cell of the scatter
    assert len(set(zip(fch.tolist(), forder.tolist()))) == len(fch)


@pytest.fixture(scope="module", params=["f16", "mulaw", "adpcm"])
def runs(request, tables, blocks):
    """Block 0, a reset of row 1, block 1 — in both pipelines."""
    fmt = request.param
    jp = jdmr.BatchedDmrVoicePipeline(C, pcm_fmt=fmt)
    tp = tdmr.BatchedDmrVoicePipeline(C, pcm_fmt=fmt, device="cpu",
                                      tables=tables)
    out = {"fmt": fmt}
    for blk in range(2):
        if blk == 1:
            jp.reset_voice_state([1])
            tp.reset_voice_state([1])
            out["reset"] = (jp._vstate, tp._vstate)
        jfe = jp.frontend_sync_device(blocks[blk])
        jh = jp.decode_from_frontend(jfe)
        th = tp.decode_block_async(blocks[blk])
        out["jframes", blk] = _jax_frames(
            jfe, jp.pick_superframes(*jfe[1:]))
        out["tframes", blk] = tuple(a.numpy() if torch.is_tensor(a) else a
                                    for a in tp.last_frames)
        out["jwire", blk], out["twire", blk] = np.asarray(jh), th.numpy()
        out["jpcm", blk], out["tpcm", blk] = (jp.fetch_pcm(jh),
                                              tp.fetch_pcm(th))
        out["jstate", blk], out["tstate", blk] = jp._vstate, tp._vstate
    return out


@needs_jax
@pytest.mark.parametrize("blk", [0, 1])
def test_dmr_bits49_and_error_counts_identical(runs, tables, blk):
    jbits, jerrs = runs["jframes", blk]
    tbits, terrs, fch, _forder = runs["tframes", blk]
    assert tbits.shape == (C * 6 * 18, 49)
    np.testing.assert_array_equal(tbits, jbits)
    np.testing.assert_array_equal(terrs, jerrs)
    # the synthetic FM leaves a few symbol errors and 25 of the 49 bits
    # are unprotected: most frames, not all, equal the vector's
    tv = tables.test_vector()
    for c in range(C):
        _pos, want = encode.expected_frames(tv, LEADS[blk][c], B // 10 - 2)
        got = tbits[fch == c].reshape(6, 18, 49)
        assert (got == want).all(-1).mean() > 0.6


@needs_jax
@pytest.mark.parametrize("blk", [0, 1])
def test_dmr_pcm_matches(runs, blk):
    fmt = runs["fmt"]
    jp, tp = runs["jpcm", blk], runs["tpcm", blk]
    jw, tw = runs["jwire", blk], runs["twire", blk]
    assert tp.shape == jp.shape == (C, 108 * 160)
    assert tw.shape == jw.shape and tw.dtype == jw.dtype
    peak = np.abs(jp).max()
    assert 0 < peak <= 1.0 + 1e-4 and np.isfinite(tp).all()
    if fmt == "f16":
        np.testing.assert_allclose(tp, jp, atol=2e-4 * peak, rtol=2.0 ** -10)
    elif fmt == "mulaw":
        assert np.mean(tw == jw) >= 0.999
        assert (np.abs(tp - jp) <= 0.05 * np.abs(jp) + 1e-3).all()
    else:
        assert np.mean(tw == jw) >= 0.99
        np.testing.assert_allclose(tp, jp, atol=peak / 8)


@needs_jax
def test_dmr_carries_and_one_row_reset(runs):
    """After each block the carries agree (theta, last ω0, repeat counts
    and flags to the bit; amplitudes rtol 1e-5); the reset between the
    blocks zeroes row 1 of every carry in both and leaves row 0."""
    def flat(st):
        return [np.asarray(a) if not torch.is_tensor(a) else a.numpy()
                for part in st for a in part]
    for blk in range(2):
        for i, (a, b) in enumerate(zip(flat(runs["tstate", blk]),
                                       flat(runs["jstate", blk]))):
            assert a.shape == b.shape and a.dtype == b.dtype, i
            if i in (2, 5):
                np.testing.assert_allclose(a, b, rtol=1e-5)
            else:
                np.testing.assert_array_equal(a, b, str(i))
    jst, tst = (flat(s) for s in runs["reset"])
    for a, b in zip(tst, jst):
        assert not a[1].any() and not b[1].any()
        np.testing.assert_array_equal(a[0] != 0, b[0] != 0)
    assert tst[0][0] != 0 and tst[2][0].any()


@needs_jax
def test_dmr_state_moves_across_and_full_reset(tables, blocks):
    """A JAX ``_vstate`` carried into the port continues the block as the
    JAX pipeline does; ``reset_voice_state()`` makes the next block equal
    a fresh pipeline's."""
    jp = jdmr.BatchedDmrVoicePipeline(C)
    tp = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    jp.decode_block(blocks[0])
    synth, rep = (tuple(np.asarray(a) for a in part) for part in jp._vstate)
    tp._vstate = params.state_from_numpy(None, synth, rep, "cpu")[1:]
    jpcm, tpcm = jp.decode_block(blocks[1]), tp.decode_block(blocks[1])
    np.testing.assert_allclose(tpcm, jpcm, atol=2e-4 * np.abs(jpcm).max(),
                               rtol=2.0 ** -10)
    tp.reset_voice_state()
    assert tp._vstate is None
    fresh = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    np.testing.assert_array_equal(tp.decode_block(blocks[0]),
                                  fresh.decode_block(blocks[0]))


@needs_jax
def test_dmr_inverted_polarity_stream(tables):
    """The FM negated: both pipelines take "-DMR BS voice" at the same
    positions and decode, after the dibit flip, the bits the upright
    stream gives."""
    tv = tables.test_vector()
    up = encode.vector_block(tv, LEADS[0], SEEDS[0], B)
    inv = encode.vector_block(tv, LEADS[0], SEEDS[0], B, invert=True)
    jp = jdmr.BatchedDmrVoicePipeline(C)
    tp = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    jfe, tfe = jp.frontend_sync_device(inv), tp.frontend_sync_device(inv)
    jpick = jp.pick_superframes(*jfe[1:])
    tpick = tp.pick_superframes(*tfe[1:])
    for a, b in zip(tpick, jpick):
        np.testing.assert_array_equal(a, b)
    assert len(tpick[0]) == 12 and tpick[2].all()
    assert tp.SYNC_NAMES[1] == "-DMR BS voice" and tp.tables.sync_inverted[1]
    tp.decode_from_frontend(tfe)
    inv_bits = tp.last_frames[0].numpy()
    tp2 = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    tp2.decode_block_async(up)
    np.testing.assert_array_equal(inv_bits, tp2.last_frames[0].numpy())


def test_dmr_no_superframe_and_bad_format(tables):
    tp = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(C, 20000, 2)).astype(np.float32)
    assert tp.decode_block_async(noise) is None
    assert tp.decode_block(noise).shape == (C, 0)
    with pytest.raises(ValueError, match="unknown pcm_fmt"):
        tdmr.BatchedDmrVoicePipeline(C, pcm_fmt="wav", device="cpu",
                                     tables=tables)


def test_dmr_entry_points_default_to_the_card(tables):
    """``BatchedDmrVoicePipeline(C)`` and ``params.load_dmr()`` with no
    device run on the card and raise where there is none."""
    if torch.cuda.is_available():
        assert tdmr.BatchedDmrVoicePipeline(C).device.type == "cuda"
        assert params.load_dmr().taps.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdmr.BatchedDmrVoicePipeline(C)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdmr.BatchedDmrVoicePipeline(C, tables=tables)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params.load_dmr()


def _dmr_pulse(dibits, sps):
    """The serial DMR stream's pulse shape (``serialvec.dmr_iq``): C4FM
    levels at DMR's ±1944 Hz outer deviation, half-symbol averaged."""
    from dsdneo_tpu_torch.engine import serialvec
    from dsdneo_tpu_torch.protocol.p25.encode import c4fm_clean
    return c4fm_clean(dibits, sps, 48000.0, serialvec.DMR_DEV_HZ)


@needs_jax
def test_dmr_c4fm_shaped_stream_every_frame_exact(tables):
    """The weak check's second half: the same ``synth_voice_stream``
    dibits through ``dmr_iq``'s pulse shape (not the Gaussian-edged FM
    of ``dmr_fm_iq``), two blocks with the carry, into both pipelines:
    every superframe each block holds accepted, every frame's 49 bits
    equal to the vector's with no ECC error, and the port's frames and
    error counts equal to the JAX pipeline's."""
    tv = tables.test_vector()
    jp = jdmr.BatchedDmrVoicePipeline(C)
    tp = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    for blk in range(2):
        block = encode.vector_block(tv, LEADS[blk], SEEDS[blk], B,
                                    modulate=_dmr_pulse)
        jfe = jp.frontend_sync_device(block)
        jp.decode_from_frontend(jfe)
        jbits, jerrs = _jax_frames(jfe, jp.pick_superframes(*jfe[1:]))
        tp.decode_block_async(block)
        tbits, terrs, fch, _forder = (a.numpy() if torch.is_tensor(a) else a
                                      for a in tp.last_frames)
        np.testing.assert_array_equal(tbits, jbits)
        np.testing.assert_array_equal(terrs, jerrs)
        assert not terrs.any()
        for c in range(C):
            _pos, want = encode.expected_frames(tv, LEADS[blk][c],
                                                B // 10 - 2)
            got = tbits[fch == c].reshape(-1, 18, 49)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# -- the hand-offs and the tracer (no JAX) ------------------------------------
SPANS = ("h2d", "frontend_enqueue", "candidates_d2h", "pick",
         "decode_enqueue", "pcm_d2h", "pcm_expand")
HAND_LEADS = ((7, 40), (0, 25), (96, 13))
HAND_SEEDS = ((1, 2), (3, 4), (5, 6))


@pytest.fixture(scope="module")
def hand_blocks(tables):
    """Three blocks as ``torch`` CPU tensors, the benchmark ring's type."""
    tv = tables.test_vector()
    return [torch.from_numpy(encode.vector_block(tv, HAND_LEADS[i],
                                                 HAND_SEEDS[i], B))
            for i in range(3)]


def _pipelined(pipe, blocks):
    """``portbench/entries/p25_pipelined.py``'s order, which the DMR
    entry runs: block N+1 dispatched before block N's candidates are
    fetched, block N−1's PCM fetched after block N's decode is queued.
    Returns each block's PCM and a copy of what it decoded (frames,
    superframes, the carry after it)."""
    pcm, got = [], []
    fe = pipe.frontend_dispatch(blocks[0])
    prev = None
    for i in range(len(blocks)):
        nxt = (pipe.frontend_dispatch(blocks[i + 1])
               if i + 1 < len(blocks) else None)
        h = pipe.decode_from_frontend(pipe.frontend_finish(fe))
        lf = pipe.last_frames
        got.append(((lf[0].clone(), lf[1].clone(), lf[2], lf[3]),
                    pipe.last_superframes,
                    [t.clone() for part in pipe.voice_state() for t in part]))
        if prev is not None:
            pcm.append(pipe.fetch_pcm(prev))
        prev, fe = h, nxt
    pcm.append(pipe.fetch_pcm(prev))
    return pcm, got


@pytest.mark.parametrize("fmt", ["f16", "mulaw", "adpcm"])
def test_dmr_pipelined_order_matches_sequential(tables, hand_blocks, fmt):
    """On the CPU device the pipelined order gives the PCM, frames,
    superframes and carries of sequential ``decode_block`` calls bit for
    bit, in every wire format."""
    def make():
        return tdmr.BatchedDmrVoicePipeline(C, pcm_fmt=fmt, device="cpu",
                                            tables=tables)
    pcm, got = _pipelined(make(), hand_blocks)
    seq = make()
    for k, b in enumerate(hand_blocks):
        np.testing.assert_array_equal(pcm[k], seq.decode_block(b))
        frames, sfs, carry = got[k]
        lf = seq.last_frames
        assert torch.equal(frames[0], lf[0]) and torch.equal(frames[1], lf[1])
        np.testing.assert_array_equal(frames[2], lf[2])
        np.testing.assert_array_equal(frames[3], lf[3])
        for a, b2 in zip(sfs, seq.last_superframes):
            np.testing.assert_array_equal(a, b2)
        for a, b2 in zip(carry, [t for part in seq.voice_state()
                                 for t in part]):
            assert torch.equal(a, b2)


def test_dmr_counters_read_what_was_decoded(tables, hand_blocks):
    """Under the profiler, in the pipelined order on the CPU device:
    every hand-off takes the blocking path (the block in, the candidates
    and the PCM out: 3 a block), each result handed to the host (2 a
    block) counts as waited for, and the counters of superframes, frames
    (18 a superframe) and synthesized slots read what was decoded."""
    pipe = tdmr.BatchedDmrVoicePipeline(C, pcm_fmt="f16", device="cpu",
                                        tables=tables)
    with profile(activities=[ProfilerActivity.CPU]):
        _pipelined(pipe, hand_blocks)
    s = trace.last_session()
    n = len(hand_blocks)
    assert s.total("dmr.blocks") == n and pipe.blocks == n
    assert s.total("dmr.blocking_handoffs") == 3 * n
    assert s.total("dmr.handoffs") == s.total("dmr.handoff_waited") == 2 * n
    n_sf = [[len(encode.expected_frames(tables.test_vector(), lead,
                                        B // 10 - 2)[0]) for lead in leads]
            for leads in HAND_LEADS]
    assert s.total("dmr.superframes") == sum(map(sum, n_sf))
    assert s.total("dmr.frames") == 18 * s.total("dmr.superframes")
    # every channel's steps, padded to 36s
    assert s.total("dmr.synth_slots") == sum(
        C * -(-18 * max(k) // 36) * 36 for k in n_sf)


def test_dmr_voice_state_is_the_carry(tables, hand_blocks):
    pipe = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    assert pipe.voice_state() == (None, None)
    pipe.decode_block(hand_blocks[0])
    synth, rep = pipe.voice_state()
    assert (synth, rep) == pipe._vstate
    assert len(synth) == 3 and len(rep) == 5
    pipe.reset_voice_state()
    assert pipe.voice_state() == (None, None)


class _Sink:
    def __init__(self):
        self.spans = []

    def on_span(self, name, block, t0, t1):
        self.spans.append((name, block, t0, t1))


def _one_block_spans(pipe, block):
    """The spans a sink sees over one block, dispatch to PCM."""
    sink = _Sink()
    trace.attach(sink)
    try:
        pcm = pipe.fetch_pcm(pipe.decode_from_frontend(
            pipe.frontend_finish(pipe.frontend_dispatch(block))))
    finally:
        trace.detach(sink)
    return sink.spans, pcm


def test_dmr_spans_once_a_block_with_its_number(tables, hand_blocks):
    """Under a sink every ``dmr.*`` span is recorded once a block, with
    the block's number, in the call order; the PCM is what an untraced
    pipeline gives."""
    pipe = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    plain = tdmr.BatchedDmrVoicePipeline(C, device="cpu", tables=tables)
    plain.decode_block(hand_blocks[0])
    pipe.decode_block(hand_blocks[0])                    # block 0, untraced
    spans, pcm = _one_block_spans(pipe, hand_blocks[1])  # block 1
    assert [n for n, *_ in spans] == [f"dmr.{n}" for n in SPANS]
    assert {b for _n, b, *_ in spans} == {1}
    assert all(t0 <= t1 for *_x, t0, t1 in spans)
    np.testing.assert_array_equal(pcm, plain.decode_block(hand_blocks[1]))


def test_x2_records_its_own_prefix():
    """``BatchedX2VoicePipeline`` inherits the hand-offs and records its
    spans and counters as ``x2.*``, none as ``dmr.*``."""
    from dsdneo_tpu_torch.engine.x2batch import BatchedX2VoicePipeline
    from dsdneo_tpu_torch.protocol.p25.encode import tdma_fm_iq
    xt = params.load_tdma("x2tdma", "cpu")
    block = encode.vector_block(xt.test_vector(), (7, 40), (1, 2), 43200,
                                sps=8, modulate=tdma_fm_iq)
    pipe = BatchedX2VoicePipeline(C, device="cpu", tables=xt)
    spans, pcm = _one_block_spans(pipe, block)
    assert pcm.shape[1] > 0
    assert [n for n, *_ in spans] == [f"x2.{n}" for n in SPANS]
    with profile(activities=[ProfilerActivity.CPU]):
        pipe.fetch_pcm(pipe.decode_block_async(block))
    names = {n for n, _b, _k in trace.last_session().counts}
    assert names == {f"x2.{n}" for n in (
        "blocks", "blocking_handoffs", "handoffs", "handoff_waited",
        "superframes", "frames", "synth_slots")}


@pytest.mark.cuda
def test_dmr_handoffs_on_the_card_do_not_synchronize():
    """On the card, with a pinned block: ``frontend_dispatch`` and
    ``decode_from_frontend`` make no synchronizing call
    (``torch.cuda.set_sync_debug_mode("error")``).  Three pinned blocks
    in the pipelined order give the PCM, frames and carries of
    sequential ``decode_block`` calls bit for bit and take every
    hand-off the stream-ordered way (candidates and PCM: 2 a block),
    none the blocking way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = params.load_dmr(dev)
    tv = card.test_vector()
    blocks = [torch.from_numpy(encode.vector_block(
        tv, HAND_LEADS[i], HAND_SEEDS[i], B)).pin_memory()
        for i in range(3)]

    def make():
        return tdmr.BatchedDmrVoicePipeline(C, pcm_fmt="adpcm", device=dev,
                                            tables=card)

    make().decode_block(blocks[0])        # builds the kernels, constants
    torch.cuda.synchronize()
    pipe = make()
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
    assert pipe.fetch_pcm(h).shape[1] > 0

    pipe = make()
    with profile(activities=[ProfilerActivity.CPU]):
        pcm, got = _pipelined(pipe, blocks)
    s = trace.last_session()
    assert s.total("dmr.blocking_handoffs") == 0
    assert s.total("dmr.handoffs") == 2 * len(blocks)
    seq = make()
    for k, b in enumerate(blocks):
        np.testing.assert_array_equal(pcm[k], seq.decode_block(b))
        frames, _sfs, carry = got[k]
        assert torch.equal(frames[0], seq.last_frames[0])
        for a, b2 in zip(carry, [t for part in seq.voice_state()
                                 for t in part]):
            assert torch.equal(a, b2)
