"""The NXDN48 and NXDN96 voice paths of the PyTorch port against the
JAX pipeline: ``BatchedNxdnVoicePipeline(2, mode=...)`` in both packages
on the CPU.

The input is the port's NXDN vector (``tools/export_torch_tables.
synth_nxdn_voice_stream``: full-voice frames built by inverting the JAX
package's NXDN tables), modulated in the form of the JAX package's test
signal (``tests/test_dsp.synth_c4fm``), with its own leading offset and
noise seed per channel, upright and with the FM negated.  The generator
is held to the JAX package's independent event-driven decoder.  Compared
with the JAX pipeline: the front end's candidates with their LICH bytes,
the accepted frames, the AMBE bits and error counts, the wire bytes and
the PCM over two blocks with the carry kept (the bounds of
``tests/test_torch_x2.py``), and the repeat carry across a block
boundary inside a run of corrupt frames.
"""

import os
import sys

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")     # the card's machine has none

from dsdneo_tpu.engine import nxdnbatch as jnx
from dsdneo_tpu.fec import device as jfec
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine import batched as tbatched
from dsdneo_tpu_torch.engine import nxdnbatch as tnx
from dsdneo_tpu_torch.protocol.dmr import encode
from dsdneo_tpu_torch.protocol.nxdn import encode as nxdn_encode

from test_torch_x2 import assert_pcm_matches, sorted_candidates

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

C = 2
N_FRAMES = 12
MODES = {"nxdn48": 20, "nxdn96": 10}           # samples per symbol
LEADS = ((7, 40), (0, 25))
SEEDS = ((1, 2), (3, 4))


def block_len(mode):
    return (N_FRAMES * 192 + 60) * MODES[mode]


@pytest.fixture(scope="module", params=sorted(MODES))
def mode(request):
    return request.param


@pytest.fixture(scope="module")
def tables(mode):
    return params.load_tdma(mode, "cpu")


def make_blocks(tables, mode, invert=False, tv=None, leads=LEADS):
    tv = tables.test_vector() if tv is None else tv
    return [encode.vector_block(tv, leads[i], SEEDS[i], block_len(mode),
                                sps=MODES[mode], invert=invert,
                                modulate=nxdn_encode.modulator(mode))
            for i in range(2)]


def test_nxdn_tables_and_modulator(tables, mode):
    jp = jnx.BatchedNxdnVoicePipeline(1, mode=mode)
    np.testing.assert_array_equal(tables.taps.numpy(), jp.taps)
    assert 48000.0 / tables.symbol_rate == jp.sps == MODES[mode]
    assert tables.sync_inverted == (False, True)
    pn9 = tables.np["nxdn_pn9_positions"]
    for a, b in zip(tnx._voice_tables(pn9), jnx._voice_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tnx._LICH_FULL_VOICE_LUT,
                                  jnx._LICH_FULL_VOICE_LUT)
    from test_dsp import synth_c4fm
    dib = tables.test_vector()["dibits"][:500]
    dev = nxdn_encode.NXDN48_DEV_HZ if mode == "nxdn48" else \
        nxdn_encode.NXDN96_DEV_HZ
    want = synth_c4fm(dib, sps=MODES[mode], dev_hz=dev, snr_db=np.inf)
    got = nxdn_encode.nxdn_fm_iq(dib, MODES[mode], dev_hz=dev)
    np.testing.assert_array_equal(got.astype(np.complex64), want)


def test_nxdn_vector_decodes_on_the_jax_event_decoder(tables, mode):
    """The generator against the JAX package's serial path: every voice
    frame its decoder reports sits at a frame of the vector and decodes
    to that frame's AMBE parameters with no error.  The serial decoder
    walks 192 dibits from any hit and so steps over a true sync after a
    false one in the random payload: it must find most of the frames,
    not all."""
    from dsdneo_tpu.engine.decoder import decode_samples
    from dsdneo_tpu.protocol.dmr.ambe_frame import decode_ambe_ecc
    from export_torch_tables import synth_nxdn_voice_stream
    tv = tables.test_vector()
    dib, bits49 = synth_nxdn_voice_stream()
    np.testing.assert_array_equal(tv["dibits"], dib)
    np.testing.assert_array_equal(tv["bits49"], bits49)
    lead, n_frames = 30, 8
    rng = np.random.default_rng(0)
    x = nxdn_encode.modulator(mode)(np.concatenate(
        [rng.integers(0, 4, lead).astype(np.uint8), dib[:n_frames * 192],
         np.zeros(300, np.uint8)]), MODES[mode])
    ctx = decode_samples(x.astype(np.complex64), mode)
    found = set()
    for e in ctx.events:
        if "voice_bits" not in e.fields:
            continue
        f, rem = divmod(e.pos - lead, 192)
        assert rem == 0 and 0 <= f < n_frames, e.pos
        found.add(f)
        vb = e.fields["voice_bits"]
        for k in range(4):
            got, errs = decode_ambe_ecc(vb[72 * k:72 * (k + 1)])
            np.testing.assert_array_equal(got, bits49[4 * f + k])
            assert errs == 0
    assert len(found) >= n_frames // 2, sorted(found)


def test_nxdn_vector_decodes_on_the_jax_pipeline(tables, mode):
    """The generator through the JAX batched pipeline: every frame
    accepted, its AMBE frames' bits the vector's."""
    xb = make_blocks(tables, mode)[0]
    jp = jnx.BatchedNxdnVoicePipeline(C, mode=mode)
    jfe = jp.frontend_sync_device(xb)
    picks = jp.pick_frames(*jfe[1:])
    bits, errs = jax_frames(jfe, picks)
    tv = tables.test_vector()
    for c in range(C):
        sel = picks[0] == c
        np.testing.assert_array_equal(picks[1][sel],
                                      LEADS[0][c] + 192 * np.arange(12))
        got = bits.reshape(-1, 4, 49)[sel].reshape(-1, 49)
        np.testing.assert_array_equal(got, tv["bits49"][:len(got)])


def jax_frames(jfe, picks):
    """The JAX device program's bits and error counts at its accepted
    frames: its dibits gathered, polarity-corrected, descrambled and
    run through its AMBE ECC."""
    dib = np.asarray(jfe[0])
    ac, at, ai = picks[:3]
    offs, flips = jnx._voice_tables()
    dd = np.stack([dib[c][np.clip(int(t) + offs, 0, dib.shape[1] - 1)]
                   ^ (2 * int(i)) ^ (2 * flips)
                   for c, t, i in zip(ac, at, ai)]).reshape(-1, 36)
    b72 = np.zeros((dd.shape[0], 72), np.uint8)
    b72[:, 0::2], b72[:, 1::2] = (dd >> 1) & 1, dd & 1
    return tuple(np.asarray(a) for a in jfec.ambe_ecc_batch(b72))


def test_nxdn_voice_decode_gather_matches(tables):
    """The device program on random dibits at chosen frame positions,
    some frames inverted: bits and error counts to the bit, the PCM as
    held."""
    rng = np.random.default_rng(3)
    F, Cx, Tn = 10, 3, 2400
    dib = rng.integers(0, 4, (Cx, Tn)).astype(np.uint8)
    f_ch = np.array([0, 0, 1, 1, 1, 2, 2, 2, 2, 3])    # the last a pad
    f_pos = rng.integers(0, Tn - 150, F)
    f_inv = rng.integers(0, 2, F)
    fch = np.repeat(f_ch, 4)
    rank = np.concatenate([np.arange(n) for n in np.bincount(f_ch)])
    forder = (4 * rank[:, None] + np.arange(4)).reshape(-1)
    offs, flips = jnx._voice_tables()
    for fmt in ("f16", "mulaw"):
        jw, _st = jnx.nxdn_voice_decode_gather(
            jnp.asarray(dib), *(jnp.asarray(a.astype(np.int32)) for a in
                                (f_ch, f_pos, f_inv)),
            jnp.asarray(offs), jnp.asarray(flips),
            jnp.asarray(fch.astype(np.int32)),
            jnp.asarray(forder.astype(np.int32)), Cx, 16, pcm_fmt=fmt)
        out = tnx.nxdn_voice_decode_gather(
            torch.as_tensor(dib), *(torch.as_tensor(a) for a in
                                    (f_ch, f_pos, f_inv)),
            torch.as_tensor(offs.astype(np.int64)), torch.as_tensor(flips),
            torch.as_tensor(fch), torch.as_tensor(forder), Cx, 16, tables,
            pcm_fmt=fmt)
        jw, tw = np.asarray(jw), out.pcm.numpy()
        assert tw.shape == jw.shape and tw.dtype == jw.dtype
        if fmt == "f16":
            peak = np.abs(jw.astype(np.float32)).max()
            np.testing.assert_allclose(tw.astype(np.float32),
                                       jw.astype(np.float32),
                                       atol=2e-4 * peak, rtol=2.0 ** -10)
        else:
            assert np.mean(tw == jw) >= 0.999
    ac = f_ch[:-1]
    jb, je = jax_frames((dib,), (ac, f_pos[:-1], f_inv[:-1]))
    np.testing.assert_array_equal(out.bits49.numpy()[:-4], jb)
    np.testing.assert_array_equal(out.errs.numpy()[:-4], je)


@pytest.mark.parametrize("invert", [False, True])
def test_nxdn_frontend_and_picks_equal(tables, mode, invert):
    """Dibits, every candidate (position, score, pattern, LICH byte) and
    the accepted frames; the inverted stream is taken by the -FSW."""
    xb = make_blocks(tables, mode, invert)[0]
    jp = jnx.BatchedNxdnVoicePipeline(C, mode=mode)
    tp = tnx.BatchedNxdnVoicePipeline(C, mode=mode, device="cpu",
                                      tables=tables)
    jfe, tfe = jp.frontend_sync_device(xb), tp.frontend_sync_device(xb)
    assert jfe[5] == tfe[5] == block_len(mode) // MODES[mode] - 2
    np.testing.assert_array_equal(tfe[0].numpy(), np.asarray(jfe[0]))
    for name, a, b in zip(("idx", "vq", "dq", "lich"),
                          sorted_candidates(tfe), sorted_candidates(jfe)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    tpick = tp.pick_frames(*tfe[1:])
    for a, b in zip(tpick, jp.pick_frames(*jfe[1:])):
        np.testing.assert_array_equal(a, b)
    assert len(tpick[0]) == 2 * 12 and (tpick[2] == int(invert)).all()


@pytest.fixture(scope="module", params=[("f16", False), ("mulaw", True),
                                        ("adpcm", False)])
def runs(request, tables, mode):
    """Two blocks with the carry kept, in both pipelines."""
    fmt, invert = request.param
    xs = make_blocks(tables, mode, invert)
    jp = jnx.BatchedNxdnVoicePipeline(C, pcm_fmt=fmt, mode=mode)
    tp = tnx.BatchedNxdnVoicePipeline(C, pcm_fmt=fmt, mode=mode,
                                      device="cpu", tables=tables)
    out = {"fmt": fmt}
    for blk in range(2):
        jfe = jp.frontend_sync_device(xs[blk])
        jh = jp.decode_from_frontend(jfe)
        th = tp.decode_block_async(xs[blk])
        out["jframes", blk] = jax_frames(jfe, jp.pick_frames(*jfe[1:]))
        out["tframes", blk] = tp.last_frames
        out["jwire", blk], out["twire", blk] = np.asarray(jh), th.numpy()
        out["jpcm", blk], out["tpcm", blk] = (jp.fetch_pcm(jh),
                                              tp.fetch_pcm(th))
        out["jstate", blk], out["tstate", blk] = jp._vstate, tp._vstate
    return out


@pytest.mark.parametrize("blk", [0, 1])
def test_nxdn_pipeline_bits_pcm_and_carries(runs, tables, blk):
    jbits, jerrs = runs["jframes", blk]
    tbits, terrs, fch, _forder, _acc = runs["tframes", blk]
    np.testing.assert_array_equal(tbits.numpy(), jbits)
    np.testing.assert_array_equal(terrs.numpy(), jerrs)
    tv = tables.test_vector()
    for c in range(C):
        got = tbits.numpy()[fch == c]
        np.testing.assert_array_equal(got, tv["bits49"][:len(got)])
    jp, tp = runs["jpcm", blk], runs["tpcm", blk]
    assert tp.shape == jp.shape == (C, 48 * 160)
    assert_pcm_matches(runs["fmt"], tp, jp, runs["twire", blk],
                       runs["jwire", blk])
    flat = lambda st: [a.numpy() if torch.is_tensor(a) else np.asarray(a)
                       for part in st for a in part]
    for i, (a, b) in enumerate(zip(flat(runs["tstate", blk]),
                                   flat(runs["jstate", blk]))):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=str(i))


def test_nxdn_repeat_count_across_a_block_boundary(tables, mode):
    """A run of corrupt frames that spans a block boundary: the port
    keeps the JAX package's repeat gate, which drops the carried repeat
    count at the boundary (``dsdneo_tpu/vocoder/device.py:346-356``), so
    the new block repeats the last good frame again.  The repeat carry
    and the PCM equal the JAX pipeline's after each block."""
    rng = np.random.default_rng(11)
    dib = tables.test_vector()["dibits"].copy()
    for f in (8, 9, 10, 12, 13):             # 11 straddles the boundary
        p = 192 * f + 10 + 38
        dib[p:p + 144] = rng.integers(0, 4, 144)
    n = 11 * 192 + 60
    tvs = [{"dibits": dib[:n + 200]}, {"dibits": dib[12 * 192:]}]
    jp = jnx.BatchedNxdnVoicePipeline(C, mode=mode)
    tp = tnx.BatchedNxdnVoicePipeline(C, mode=mode, device="cpu",
                                      tables=tables)
    for blk, tv in enumerate(tvs):
        xb = encode.vector_block(tv, (0, 0), SEEDS[blk], n * MODES[mode],
                                 sps=MODES[mode],
                                 modulate=nxdn_encode.modulator(mode))
        jpcm, tpcm = jp.decode_block(xb), tp.decode_block(xb)
        np.testing.assert_allclose(tpcm, jpcm,
                                   atol=2e-4 * np.abs(jpcm).max(),
                                   rtol=2.0 ** -10)
        trep = [a.numpy() for a in tp._vstate[1]]
        jrep = [np.asarray(a) for a in jp._vstate[1]]
        for a, b in zip(trep, jrep):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
        if blk == 0:
            # 12 corrupt AMBE frames end the block: the carry holds the
            # count past the limit of 3 repeats
            np.testing.assert_array_equal(trep[3], 4)
        else:
            # ... and yet the new block's first 3 corrupt frames repeat
            # the last good frame again, where a carried count would mute
            _b, errs, fch, forder, _acc = tp.last_frames
            first = errs.numpy()[(fch == 0) & (forder < 4)]
            assert (first > 3).all()
            assert (np.abs(tpcm[0, :3 * 160].reshape(3, 160)).max(1)
                    > 0).all()


@pytest.mark.parametrize("n_sym_extra", [0, 2])
def test_frontend_step_integer_and_interpolating_timing(tables, mode,
                                                        n_sym_extra):
    """``frontend_step`` at 20 and 10 samples per symbol, with the
    pipelines' symbol count (the integer path: n_sym · sps + sps ≤ B) and
    with two symbols more, where that fails and the timing interpolates:
    dibits off the slicer thresholds equal, soft symbols within 1e-4."""
    from dsdneo_tpu.engine.batched import frontend_step as jfs
    import jax
    sps = MODES[mode]
    xb = make_blocks(tables, mode)[0]
    n_sym = block_len(mode) // sps - 2 + n_sym_extra
    assert (n_sym * sps + sps <= xb.shape[1]) == (n_sym_extra == 0)
    jd, js, jpow = jax.jit(lambda x: jfs(x, np.asarray(tables.taps),
                                         float(sps), n_sym, True))(
        jnp.asarray(xb))
    td, ts, tpow = tbatched.frontend_step(torch.as_tensor(xb), tables.taps,
                                          float(sps), n_sym)
    js = np.asarray(js)
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-4)
    off = (np.abs(np.abs(js) - 2.0) > 1e-3) & (np.abs(js) > 1e-3)
    np.testing.assert_array_equal(td.numpy()[off], np.asarray(jd)[off])
    np.testing.assert_allclose(tpow.numpy(), np.asarray(jpow), rtol=1e-5)


def test_nxdn_modes_and_entry_point(tables, mode):
    with pytest.raises(ValueError, match="unknown NXDN mode"):
        tnx.BatchedNxdnVoicePipeline(C, mode="dpmr", device="cpu",
                                     tables=tables)
    other = "nxdn96" if mode == "nxdn48" else "nxdn48"
    with pytest.raises(ValueError, match="tables of"):
        tnx.BatchedNxdnVoicePipeline(C, mode=other, device="cpu",
                                     tables=tables)
    if torch.cuda.is_available():
        assert tnx.BatchedNxdnVoicePipeline(C, mode=mode
                                            ).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnx.BatchedNxdnVoicePipeline(C, mode=mode)
