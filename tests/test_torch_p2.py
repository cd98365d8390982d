"""The P25 Phase 2 two-slot TDMA voice path of the PyTorch port against
the JAX pipeline: ``BatchedP2VoicePipeline(2)`` in both packages on the
CPU, in the clear and with ADP encryption.

Inputs: the port's P2 test vectors (the JAX package's
``synth_p2_voice_stream(8, seed=1)``, the bench's stream, and the
ADP/RC4 stream of ``tests/test_p2batch.py``), modulated as the JAX
generator modulates them, with their own leading offset and noise seed
per channel.  Compared: the front end's candidates with their DUID
octets and ISCH bytes, the walk arrays, the ESS jobs, ``bits49``, the
error counts, the wire bytes and the PCM over two blocks with the carry
kept, the ISCH memo and the crypto state across blocks.  Candidates are
compared as sets and the PCM and wire bytes under the bounds of
``tests/test_torch_x2.py`` (the soft symbols and the synthesized PCM
agree to ~1e-5, not to the bit).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")     # the card's machine has none

from dsdneo_tpu.crypto.keyring import KeyRing as JKeyRing
from dsdneo_tpu.engine import p2batch as jp2
from dsdneo_tpu.fec import device as jfec
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.crypto.keyring import KeyRing
from dsdneo_tpu_torch.engine import p2batch as tp2
from dsdneo_tpu_torch.protocol.dmr import encode
from dsdneo_tpu_torch.protocol.p25 import p2_xcch
from dsdneo_tpu_torch.protocol.p25.encode import tdma_fm_iq

from test_torch_x2 import assert_pcm_matches, sorted_candidates

C = 2
B = 3 * 2160 * 8 + 960      # 3 superframes and the lead
LEADS = ((5, 61), (0, 30))  # per block, per channel
SEEDS = ((1, 2), (3, 4))
ADP_B = 8740 * 8            # the whole 4-superframe ADP stream


@pytest.fixture(scope="module")
def tables():
    return params.load_tdma("p25p2", "cpu")


@pytest.fixture(scope="module")
def blocks(tables):
    tv = tables.test_vector()
    return [encode.vector_block(tv, LEADS[i], SEEDS[i], B, sps=8,
                                modulate=tdma_fm_iq) for i in range(2)]


def adp_vector(tables):
    tv = tables.test_vector()
    return {k[4:]: v for k, v in tv.items() if k.startswith("adp_")}


def test_p2_tables_vectors_and_host_pieces(tables):
    """Front end, DUID and ISCH tables, the scrambler and the vectors are
    the JAX package's."""
    from dsdneo_tpu.protocol.p25 import p2_xcch as jx
    jp = jp2.BatchedP2VoicePipeline(1)
    np.testing.assert_array_equal(tables.taps.numpy(), jp.taps)
    assert tables.symbol_rate == 6000.0 and tables.sync_len == 20
    np.testing.assert_array_equal(tables.np["p2_duid_lut"], jp._duid_lut())
    keys, vals = jp._isch_arrays()
    np.testing.assert_array_equal(tables.np["p2_isch_keys"], keys)
    np.testing.assert_array_equal(tables.np["p2_isch_vals"], vals)
    assert p2_xcch.ISCH_SYNC == jx.ISCH_SYNC
    for w in (0x0123456789, 0x575D57F7FE, int(keys[5]) ^ 0x1001):
        assert p2_xcch.isch_lookup(w, keys, vals) == jx.isch_lookup(w)
    np.testing.assert_array_equal(
        p2_xcch.generate_scramble_bits(0xBEE00, 0x14C, 0x140, 4700),
        jp._scr)
    iq, dib, bits49 = jp2.synth_p2_voice_stream(n_superframes=8, seed=1)
    tv = tables.test_vector()
    np.testing.assert_array_equal(tv["dibits"], dib)
    np.testing.assert_array_equal(tv["bits49"], bits49)
    np.testing.assert_array_equal(tdma_fm_iq(dib).astype(np.complex64), iq)
    adp = adp_vector(tables)
    n_sf, seed, alg, kid, key, mi = (int(v) for v in adp["params"])
    _iq, dib, bits49 = jp2.synth_p2_voice_stream(
        n_superframes=n_sf, seed=seed, alg=alg, kid=kid, key=key, mi=mi)
    np.testing.assert_array_equal(adp["dibits"], dib)
    np.testing.assert_array_equal(adp["bits49"], bits49)


def test_p2_voice_decode_gather_matches():
    """The device program on random dibits at chosen frame positions,
    rows and offsets, a keystream on half the frames: bits and error
    counts to the bit, the PCM and the carries as the pipelines are
    held."""
    rng = np.random.default_rng(7)
    t = params.load_tdma("p25p2", "cpu")
    F, C2, Tp = 64, 4, 36
    dib = rng.integers(0, 4, (2, 3000)).astype(np.uint8)
    scr = p2_xcch.generate_scramble_bits(0xBEE00, 0x14C, 0x140, 4700)
    f_ch = rng.integers(0, 2, F)
    f_tpos = rng.integers(0, 2800, F)
    f_row = rng.integers(0, 12, F)
    f_off = rng.integers(0, 4, F)
    f_out = np.repeat(np.arange(C2), F // C2)
    f_ord = np.tile(np.arange(F // C2), C2)
    f_out[-3:] = C2                          # pad frames
    ks = rng.integers(0, 256, (F, 7)).astype(np.uint8)
    ks[::2] = 0
    for fmt in ("f16", "adpcm"):
        jw, jst = jp2.p2_voice_decode_gather(
            jnp.asarray(dib), jnp.asarray(scr), *(jnp.asarray(a.astype(
                np.int32)) for a in (f_ch, f_tpos, f_row, f_off, f_out,
                                     f_ord)), jnp.asarray(ks), C2, Tp,
            pcm_fmt=fmt)
        out = tp2.p2_voice_decode_gather(
            torch.as_tensor(dib), torch.as_tensor(scr),
            *(torch.as_tensor(a) for a in (f_ch, f_tpos, f_row, f_off,
                                           f_out, f_ord)),
            torch.as_tensor(ks), C2, Tp, t, pcm_fmt=fmt)
        jw = np.asarray(jw)
        tw = out.pcm.numpy()
        if fmt == "f16":
            peak = np.abs(jw.astype(np.float32)).max()
            np.testing.assert_allclose(tw.astype(np.float32),
                                       jw.astype(np.float32),
                                       atol=2e-4 * peak, rtol=2.0 ** -10)
        else:
            assert tw.shape == jw.shape and np.mean(tw == jw) >= 0.99
    # the JAX program's bits: its gather, descramble and ECC, then the
    # keystream
    offd = np.array([o // 2 for o in tp2.VOICE_BIT_OFFS])
    offb = np.array(tp2.VOICE_BIT_OFFS)
    gp = np.clip((f_tpos + offd[f_off])[:, None] + np.arange(36), 0, 2999)
    dd = dib[f_ch[:, None], gp]
    b72 = np.zeros((F, 72), np.uint8)
    b72[:, 0::2], b72[:, 1::2] = (dd >> 1) & 1, dd & 1
    b72 ^= scr[(360 * f_row + 20 + offb[f_off])[:, None] + np.arange(72)]
    jb, je = (np.asarray(a) for a in jfec.ambe_ecc_batch(b72))
    jb = jb ^ np.unpackbits(ks, axis=1)[:, :49]
    np.testing.assert_array_equal(out.bits49.numpy(), jb)
    np.testing.assert_array_equal(out.errs.numpy(), je)


@pytest.fixture(scope="module")
def fronts(tables, blocks):
    jp = jp2.BatchedP2VoicePipeline(C)
    tp = tp2.BatchedP2VoicePipeline(C, device="cpu", tables=tables)
    return (jp, jp.frontend_sync_device(blocks[0]),
            tp, tp.frontend_sync_device(blocks[0]))


def test_p2_frontend_candidates_equal(fronts):
    """Dibits, and every candidate's position, score, DUID octets and
    ISCH bytes: the port's first 64 of its 128 are the JAX package's
    64."""
    _jp, jfe, _tp, tfe = fronts
    assert jfe[5] == tfe[5] == B // 8 - 2
    np.testing.assert_array_equal(tfe[0].numpy(), np.asarray(jfe[0]))
    assert tfe[3].shape == (C, 128, 4) and tfe[4].shape == (C, 128, 4, 5)
    top = (None, *(a[:, :64] for a in tfe[1:5]))
    for name, a, b in zip(("idx", "vq", "duid", "isch"),
                          sorted_candidates(top), sorted_candidates(jfe)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)


def test_p2_walk_frames_identical(fronts, tables):
    """The walk arrays and, with a keyring, the ESS jobs."""
    jp, jfe, tp, tfe = fronts
    (tarrs, tjobs), (jarrs, jjobs) = (tp.walk_frames(*tfe[1:]),
                                      jp.walk_frames(*jfe[1:]))
    for a, b in zip(tarrs, jarrs):
        np.testing.assert_array_equal(a, b)
    assert tjobs == jjobs == []
    jk = jp2.BatchedP2VoicePipeline(C, keyring=JKeyRing())
    tk = tp2.BatchedP2VoicePipeline(C, keyring=KeyRing(), device="cpu",
                                    tables=tables)
    (_a, tjobs), (_b, jjobs) = (tk.walk_frames(*tfe[1:]),
                                jk.walk_frames(*jfe[1:]))
    assert tjobs == jjobs and len(tjobs) == C * 2 * 3 * 5


@pytest.fixture(scope="module", params=["f16", "mulaw", "adpcm"])
def runs(request, tables, blocks):
    """Two blocks with the carry kept, in both pipelines."""
    fmt = request.param
    jp = jp2.BatchedP2VoicePipeline(C, pcm_fmt=fmt)
    tp = tp2.BatchedP2VoicePipeline(C, pcm_fmt=fmt, device="cpu",
                                    tables=tables)
    out = {"fmt": fmt}
    for blk in range(2):
        jfe = jp.frontend_sync_device(blocks[blk])
        jh = jp.decode_from_frontend(jfe)
        th = tp.decode_block_async(blocks[blk])
        out["jwalk", blk] = jp.walk_frames(*jfe[1:])[0]
        out["tframes", blk] = tp.last_frames
        out["jwire", blk], out["twire", blk] = np.asarray(jh), th.numpy()
        out["jpcm", blk], out["tpcm", blk] = (jp.fetch_pcm(jh),
                                              tp.fetch_pcm(th))
        out["jstate", blk], out["tstate", blk] = jp._vstate, tp._vstate
    return out


@pytest.mark.parametrize("blk", [0, 1])
def test_p2_pipeline_bits_walk_and_pcm(runs, tables, blk):
    """The walk arrays are the JAX pipeline's; every (channel, slot)
    stream decodes the vector's bits on every frame; PCM and carries
    as held."""
    tbits, terrs, tarrs, _jobs = runs["tframes", blk]
    for a, b in zip(tarrs, runs["jwalk", blk]):
        np.testing.assert_array_equal(a, b)
    f_out, f_ord = tarrs[4], tarrs[5]
    tbits = tbits.numpy()
    tv = tables.test_vector()
    for r in range(2 * C):
        sel = np.flatnonzero(f_out == r)
        sel = sel[np.argsort(f_ord[sel])]
        assert len(sel) >= 2 * 18
        np.testing.assert_array_equal(tbits[sel], tv["bits49"][r % 2][
            :len(sel)])
    assert not terrs.numpy().any()
    jp, tp = runs["jpcm", blk], runs["tpcm", blk]
    assert tp.shape == jp.shape and tp.shape[0] == 2 * C
    assert_pcm_matches(runs["fmt"], tp, jp, runs["twire", blk],
                       runs["jwire", blk])
    flat = lambda st: [a.numpy() if torch.is_tensor(a) else np.asarray(a)
                       for part in st for a in part]
    for i, (a, b) in enumerate(zip(flat(runs["tstate", blk]),
                                   flat(runs["jstate", blk]))):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=str(i))


def test_p2_full_block_keeps_every_frame_sync(tables):
    """The bench's 2.9 s block: 8 superframes hold 72 positions that match
    the sync pattern (each frame's sync and two ISCH copies of it).  The
    JAX package keeps 64 candidates and garbles frames; the port keeps
    128 and decodes every frame the block holds whole.  With 64 the
    port's walk is the JAX package's."""
    tv = tables.test_vector()
    n = len(tv["dibits"]) * 8
    x = encode.vector_block(tv, (96,), (5,), n, sps=8, modulate=tdma_fm_iq)
    jp = jp2.BatchedP2VoicePipeline(1)
    tp = tp2.BatchedP2VoicePipeline(1, device="cpu", tables=tables)
    jfe, tfe = jp.frontend_sync_device(x), tp.frontend_sync_device(x)
    assert int((tfe[2] >= 0.62 * 127).sum()) >= 70
    narrow = tp2.BatchedP2VoicePipeline(1, device="cpu", tables=tables)
    narrow.SYNC_TOPK = 64
    nfe = narrow.frontend_sync_device(x)
    for a, b in zip(narrow.walk_frames(*nfe[1:])[0],
                    jp.walk_frames(*jfe[1:])[0]):
        np.testing.assert_array_equal(a, b)
    tbits, tout, tord = tp.decode_block_bits49(x)
    jbits, jout, jord = jp.decode_block_bits49(x)
    for r in (0, 1):
        got = _slot_bits(tbits, tout, tord, r)
        assert len(got) >= 7 * 18
        np.testing.assert_array_equal(got, tv["bits49"][r][:len(got)])
        jgot = _slot_bits(jbits, jout, jord, r)
        assert not np.array_equal(jgot, tv["bits49"][r][:len(jgot)])


def test_p2_isch_memo_and_state_across_blocks(tables):
    """A stream with corrupted ISCH words: both pipelines memoize the
    same nearest-codeword lookups across blocks; a JAX carry handed to
    the port continues the next block as the JAX pipeline does."""
    tv = dict(tables.test_vector())
    dib = tv["dibits"].copy()
    for sf in range(3):             # one ISCH dibit per frame of slot 0
        for f in range(3):
            dib[40 + 2160 * sf + 720 * f + 20 + 165] ^= 1
    tv["dibits"] = dib
    xs = [encode.vector_block(tv, LEADS[i], SEEDS[i], B, sps=8,
                              modulate=tdma_fm_iq) for i in range(2)]
    jp = jp2.BatchedP2VoicePipeline(C)
    tp = tp2.BatchedP2VoicePipeline(C, device="cpu", tables=tables)
    jp.decode_block(xs[0])
    tp.decode_block(xs[0])
    assert tp._isch_memo == jp._isch_memo and len(tp._isch_memo) >= 1
    synth, rep = (tuple(np.asarray(a) for a in part) for part in jp._vstate)
    tp._vstate = params.state_from_numpy(None, synth, rep, "cpu")[1:]
    jpcm, tpcm = jp.decode_block(xs[1]), tp.decode_block(xs[1])
    assert tp._isch_memo == jp._isch_memo
    np.testing.assert_allclose(tpcm, jpcm, atol=2e-4 * np.abs(jpcm).max(),
                               rtol=2.0 ** -10)


def _adp_blocks(tables, dibits=None, leads=(5, 17)):
    adp = adp_vector(tables)
    tv = {"dibits": adp["dibits"] if dibits is None else dibits}
    return [encode.vector_block(tv, leads, (11 + i, 12 + i), ADP_B, sps=8,
                                modulate=tdma_fm_iq) for i in range(2)]


def _slot_bits(bits, f_out, f_ord, row):
    sel = np.flatnonzero(f_out == row)
    return bits[sel[np.argsort(f_ord[sel])]]


@pytest.mark.parametrize("corrupt", [False, True])
def test_p2_adp_decrypts_and_carries_crypto_state(tables, corrupt,
                                                  monkeypatch):
    """With the key: exact bits from the second superframe on, cipher on
    the first; the ESS jobs, the bits and the crypto state equal the
    JAX pipeline's after each of two blocks.  ``corrupt``: three
    dibits of the first 2V ESS word of slot 0 are flipped, so its RS
    syndromes are not zero and the host RS(63,35) decoder corrects it."""
    adp = adp_vector(tables)
    n_sf, _seed, _alg, kid, key, _mi = (int(v) for v in adp["params"])
    dib = adp["dibits"].copy()
    if corrupt:
        ts = 40 + 2 * 720 + 20             # superframe 0, frame 2, ts 0
        dib[ts + np.array([80, 95, 110])] ^= 2
    xs = _adp_blocks(tables, dib)
    decoded = []
    real = tp2.rs_63_35

    class Spy:
        def decode(self, w):
            r = real().decode(w)
            decoded.append(r[1])
            return r

    monkeypatch.setattr(tp2, "rs_63_35", lambda: Spy())
    jk, tk = JKeyRing(), KeyRing()
    jk.scalar[kid] = key
    tk.scalar[kid] = key
    jp = jp2.BatchedP2VoicePipeline(C, keyring=jk)
    tp = tp2.BatchedP2VoicePipeline(C, keyring=tk, device="cpu",
                                    tables=tables)
    for blk in range(2):
        jbits, jout, jord = jp.decode_block_bits49(xs[blk])
        tbits, tout, tord = tp.decode_block_bits49(xs[blk])
        np.testing.assert_array_equal(tbits, jbits)
        np.testing.assert_array_equal(tout, jout)
        np.testing.assert_array_equal(tord, jord)
        assert tp.last_frames[3] == jp.walk_frames(
            *jp.frontend_sync_device(xs[blk])[1:])[1]
        assert tp.crypto == jp.crypto
        for r in range(2 * C):
            got = _slot_bits(tbits, tout, tord, r)
            assert len(got) >= (n_sf - 1) * 18
            np.testing.assert_array_equal(
                got[18:], adp["bits49"][r % 2][18:len(got)])
            if blk == 0:
                assert (got[:18] != adp["bits49"][r % 2][:18]).any()
    if corrupt:
        assert any(1 <= n < 15 for n in decoded), decoded
    else:
        assert decoded == []


def test_p2_adp_ess_screen_flags_the_words_jax_flags(tables, monkeypatch):
    """The ESS path's K7 screen over two blocks, three dibits of one 2V
    ESS word flipped: the port hands the screen host words (numpy, so
    their range is checked on the host and nothing is read from the
    device before the launch), the same RS(63,35) words as the JAX
    pipeline, and finds the same ones clean."""
    adp = adp_vector(tables)
    _n_sf, _seed, _alg, kid, key, _mi = (int(v) for v in adp["params"])
    dib = adp["dibits"].copy()
    dib[40 + 2 * 720 + 20 + np.array([80, 95, 110])] ^= 2
    xs = _adp_blocks(tables, dib)
    seen = {"jax": [], "torch": []}

    def spy(side, real):
        def screen(words, *a, **kw):
            out = real(words, *a, **kw)
            if side == "torch":
                assert isinstance(words, np.ndarray)
            seen[side].append((np.asarray(words),
                               np.asarray(out).any(axis=1)))
            return out
        return screen

    monkeypatch.setattr(jfec, "rs_syndromes_batch",
                        spy("jax", jfec.rs_syndromes_batch))
    monkeypatch.setattr(tp2, "rs_syndromes_batch",
                        spy("torch", tp2.rs_syndromes_batch))
    jk, tk = JKeyRing(), KeyRing()
    jk.scalar[kid] = key
    tk.scalar[kid] = key
    jp = jp2.BatchedP2VoicePipeline(C, keyring=jk)
    tp = tp2.BatchedP2VoicePipeline(C, keyring=tk, device="cpu",
                                    tables=tables)
    for x in xs:
        jp.decode_block_bits49(x)
        tp.decode_block_bits49(x)
    assert len(seen["jax"]) == len(seen["torch"]) == 2
    for (jw, jflag), (tw, tflag) in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tflag, jflag)
    flags = np.concatenate([f for _w, f in seen["torch"]])
    assert flags.any() and not flags.all()
    assert tp.last_ess["rs_words"] == len(seen["torch"][1][0])
    assert tp.last_ess["host_rs_decodes"] == int(seen["torch"][1][1].sum())


def test_p2_adp_without_keyring_leaves_cipher(tables):
    """No keyring: the frames decode to the cipher bits, as in the JAX
    pipeline, and the crypto state is not touched."""
    adp = adp_vector(tables)
    xs = _adp_blocks(tables)
    jp = jp2.BatchedP2VoicePipeline(C)
    tp = tp2.BatchedP2VoicePipeline(C, device="cpu", tables=tables)
    jbits, _o, _r = jp.decode_block_bits49(xs[0])
    tbits, tout, tord = tp.decode_block_bits49(xs[0])
    np.testing.assert_array_equal(tbits, jbits)
    got = _slot_bits(tbits, tout, tord, 0)
    assert (got[:18] != adp["bits49"][0][:18]).any()
    assert (got[18:] != adp["bits49"][0][18:len(got)]).any()
    assert tp.crypto == jp.crypto == [tp2._new_crypto()
                                      for _ in range(2 * C)]


def test_p2_entry_point_defaults_to_the_card(tables):
    if torch.cuda.is_available():
        assert tp2.BatchedP2VoicePipeline(C).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp2.BatchedP2VoicePipeline(C)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params.load_tdma("p25p2")
