"""The batched host leftovers of the port against the JAX package, on the
CPU: ``vocoder/batch.py`` (``BatchedImbeDecoder``, ``decode_transforms``,
``run_prediction``), ``engine/batched.make_frontend_step`` for every
four-level FM mode of the mode table, the parity paths of
``BatchedP25VoicePipeline`` (``frontend_sync``, ``frontend``,
``find_voice_frames``, ``find_voice_frames_best``, ``decode_block_host``
and its ``_synth_multichannel``) and ``dsp/audio_filters.
upsample_8k_to_48k``.

Tolerances: the IMBE dequantizer bit for bit (numpy in both packages);
soft symbols within 2e-4 (the FIR and discriminator's float32 rounding),
dibits equal wherever the soft symbol is more than that from a slicing
threshold (0, ±2), sync candidates that clear the 0.62 threshold equal in
position and pattern, their uint8 scores within one step, and their NID
messages equal; the voice frames found equal; ``decode_block_host``'s
PCM within 2e-3 of its peak (the synthesis runs from float16
amplitudes in both), and its distance from ``decode_block``'s the same
in both packages within 2e-3 of the peak; the upsampler within 1e-6 of
its peak.

The JAX package is imported inside the tests, so the ``cuda`` cases (K1
at ``make_frontend_step``'s shapes) run on a machine without it.
"""

import numpy as np
import pytest
import torch

C = 2
B = 72000                   # 1.5 s: 8 whole LDUs per channel
LEADS = (30, 77)
THRESH = 0.62
SOFT_TOL = 2e-4
PCM_REL = 2e-3
FOUR_LEVEL = ("p25p1", "p25p2", "dmr", "nxdn48", "nxdn96", "dpmr", "ysf",
              "m17", "x2tdma", "auto")


@pytest.fixture(scope="module")
def jax_cpu():
    pytest.importorskip("jax")
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


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


def _fsk_block(mode: str, c: int, b: int, seed: int) -> np.ndarray:
    """``[c, b, 2]`` float32: random four-level FSK at the mode's symbol
    rate (deviation ±600/±1800 Hz scaled to its rate), a random carrier
    phase and complex noise at ~20 dB SNR per channel."""
    from dsdneo_tpu_torch.engine.modes import MODES
    rng = np.random.default_rng(seed)
    sps = 48000.0 / MODES[mode].symbol_rate
    n_sym = int(b / sps) + 2
    lv = np.array([1.0, 3.0, -1.0, -3.0])
    dev = 600.0 * MODES[mode].symbol_rate / 4800.0
    out = np.empty((c, b, 2), dtype=np.float32)
    for ch in range(c):
        sym = lv[rng.integers(0, 4, n_sym)]
        f = np.repeat(sym, int(np.ceil(sps)))[:b] * dev
        ph = 2 * np.pi * np.cumsum(f) / 48000.0 + rng.uniform(0, 2 * np.pi)
        z = np.exp(1j * ph) + 0.1 * (rng.standard_normal(b)
                                     + 1j * rng.standard_normal(b))
        out[ch, :, 0] = z.real
        out[ch, :, 1] = z.imag
    return out


def _off_threshold(soft: np.ndarray) -> np.ndarray:
    return ((np.abs(soft) > SOFT_TOL)
            & (np.abs(np.abs(soft) - 2.0) > SOFT_TOL))


# -- vocoder/batch ----------------------------------------------------------
def _imbe_frames(n: int, seed: int) -> np.ndarray:
    """``[n, 88]`` parameter bits: random bits with b0 kept a voice code
    (0-207) for most frames and a few out of range."""
    from dsdneo_tpu_torch.vocoder import imbe
    rng = np.random.default_rng(seed)
    S = rng.integers(0, 2, (n, 88)).astype(np.uint8)
    b0 = rng.integers(0, 230, n)
    for i, p in enumerate(imbe.B0_HI_POS):
        S[:, p] = (b0 >> (7 - i)) & 1
    S[:, imbe.B0_LO_POS[0]] = (b0 >> 1) & 1
    S[:, imbe.B0_LO_POS[1]] = b0 & 1
    return S


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_imbe_step_bit_for_bit(jax_cpu, seed):
    from dsdneo_tpu.vocoder import batch as JB
    from dsdneo_tpu_torch.vocoder import batch as PB
    Cn = 6
    jd, pd = JB.BatchedImbeDecoder(Cn), PB.BatchedImbeDecoder(Cn)
    rng = np.random.default_rng(100 + seed)
    for t in range(12):
        S = _imbe_frames(Cn, 1000 * seed + t)
        active = rng.random(Cn) > 0.25
        for a, b in zip(jd.step(S, active), pd.step(S, active)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(pd.prev_logm, jd.prev_logm)
    np.testing.assert_array_equal(pd.prev_L, jd.prev_L)


@pytest.mark.parametrize("seed", [3, 4])
def test_decode_transforms_and_run_prediction_bit_for_bit(jax_cpu, seed):
    from dsdneo_tpu.vocoder import batch as JB
    from dsdneo_tpu_torch.vocoder import batch as PB
    S_all = _imbe_frames(40, seed)
    jt, pt = JB.decode_transforms(S_all), PB.decode_transforms(S_all)
    for a, b in zip(jt, pt):
        np.testing.assert_array_equal(b, a)
    Cn = 8
    jd, pd = JB.BatchedImbeDecoder(Cn), PB.BatchedImbeDecoder(Cn)
    rng = np.random.default_rng(seed)
    for t in range(5):
        sel = rng.choice(40, Cn, replace=False)
        T, w0, L, K = (a[sel] for a in jt)
        act = rng.random(Cn) > 0.2
        ja = JB.run_prediction(jd, T, w0, L, K, S_all[sel], act)
        pa = PB.run_prediction(pd, T, w0, L, K, S_all[sel], act)
        for a, b in zip(ja, pa):
            np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(pd.prev_logm, jd.prev_logm)


# -- engine/batched.make_frontend_step -------------------------------------
@pytest.mark.parametrize("mode", FOUR_LEVEL)
def test_make_frontend_step_per_mode(jax_cpu, mode):
    from dsdneo_tpu.engine.batched import make_frontend_step as jmake
    from dsdneo_tpu_torch.engine.batched import make_frontend_step as pmake
    Bm = 9600
    x = _fsk_block(mode, 3, Bm, seed=len(mode))
    jd, js, jp = (np.asarray(a) for a in jmake(mode, Bm)(x))
    pd, ps, pp = pmake(mode, Bm, device="cpu")(x)
    assert pd.dtype == torch.uint8 and ps.shape == js.shape
    np.testing.assert_allclose(ps.numpy(), js, atol=SOFT_TOL)
    off = _off_threshold(js)
    assert off.mean() > 0.99
    np.testing.assert_array_equal(pd.numpy()[off], jd[off])
    np.testing.assert_allclose(pp.numpy(), jp, rtol=1e-5)
    # complex64 input: the same step
    z = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    zd, zs, _ = pmake(mode, Bm, device="cpu")(z)
    np.testing.assert_array_equal(zs.numpy(), ps.numpy())


# -- BatchedP25VoicePipeline parity paths ----------------------------------
@pytest.fixture(scope="module")
def pipes(jax_cpu, tables):
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline as JP
    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    return JP(C), TP(C, device="cpu", tables=tables)


@pytest.fixture(scope="module")
def syncs(pipes, blocks):
    jp, tp = pipes
    return jp.frontend_sync(blocks[0]), tp.frontend_sync(blocks[0])


def test_frontend_sync_matches(syncs, pipes, blocks):
    (jd, jbd, jbs, jnm), (td, tbd, tbs, tnm) = syncs
    assert td.dtype == np.uint8 and tnm.dtype == np.uint16
    assert tbs.dtype == np.float32 and tbs.shape == jbs.shape
    np.testing.assert_array_equal(td, jd)
    # the front end's dibits equal frontend_dispatch's
    tp = pipes[1]
    np.testing.assert_array_equal(
        td, tp.frontend_dispatch(blocks[0])[0].numpy())
    for c in range(C):
        strong = jbs[c] >= THRESH
        assert strong.sum() >= 8
        np.testing.assert_array_equal(tbs[c] >= THRESH, strong)
        assert np.abs(tbs[c][strong] - jbs[c][strong]).max() <= 1 / 127 + 1e-7
        np.testing.assert_array_equal(tbd[c][strong], jbd[c][strong])
        both = strong & (jnm[c] != 0xFFFF) & (tnm[c] != 0xFFFF)
        assert both.sum() >= 8
        np.testing.assert_array_equal(tnm[c][both], jnm[c][both])


def test_frontend_soft_symbols(pipes, blocks):
    jp, tp = pipes
    jd, js, jpow = (np.asarray(a) for a in jp.frontend(blocks[0]))
    td, ts, tpow = tp.frontend(blocks[0])
    np.testing.assert_allclose(ts.numpy(), js, atol=SOFT_TOL)
    off = _off_threshold(js)
    np.testing.assert_array_equal(td.numpy()[off], jd[off])
    np.testing.assert_allclose(tpow.numpy(), jpow, rtol=1e-5)


def test_find_voice_frames_best_matches(syncs, pipes, tables):
    jp, tp = pipes
    (jd, jbd, jbs, jnm), _ = syncs
    T = jd.shape[1]
    want = jp.find_voice_frames_best(jd, jbd, jbs, T, jnm)
    got = tp.find_voice_frames_best(jd, jbd, jbs, T, jnm)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    frames, fch, forder = got
    assert frames.shape == (2 * 72, 144)
    # every NID decoded here (no device messages) gives the same frames
    got2 = tp.find_voice_frames_best(jd, jbd, jbs, T, None)
    for a, b in zip(want, got2):
        np.testing.assert_array_equal(b, a)


def test_find_voice_frames_from_soft(pipes, blocks):
    jp, tp = pipes
    jd, js, _ = (np.asarray(a) for a in jp.frontend(blocks[0]))
    want = jp.find_voice_frames(jd, js)
    got = tp.find_voice_frames(jd, js)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert got[0].shape[0] == 2 * 72


def test_decode_block_host_matches(jax_cpu, tables, blocks):
    """Two blocks through fresh pipelines of each package (the host
    prediction state carried across the blocks in both)."""
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline as JP
    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    jp, tp = JP(C), TP(C, device="cpu", tables=tables)
    for blk in range(2):
        want = jp.decode_block_host(blocks[blk])
        got = tp.decode_block_host(blocks[blk])
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape == (C, 72 * 160)
        peak = float(np.abs(want).max())
        assert peak > 0 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=PCM_REL * peak)
    np.testing.assert_array_equal(tp.imbe_dec.prev_L, jp.imbe_dec.prev_L)


def test_device_host_gap_as_in_jax(jax_cpu, tables):
    """``decode_block`` against ``decode_block_host`` on 3 s of the
    vector (4 channels), in each package: the two paths part by the same
    amount in both (the host path's float16 amplitudes and float64-born
    ω0 drift its phase over the block), equal to within 2e-3 of the
    peak, and the device path's padded tail is silent."""
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline as JP
    from dsdneo_tpu_torch.engine.voicebatch import \
        BatchedP25VoicePipeline as TP
    from dsdneo_tpu_torch.protocol.p25 import encode
    rng = np.random.default_rng(1)
    blk = encode.vector_block(tables.test_vector(),
                              rng.integers(30, 200, size=4),
                              rng.integers(0, 1 << 20, 4), 144000)
    gaps = {}
    for name, P, kw in (("jax", JP, {}),
                        ("port", TP, {"device": "cpu", "tables": tables})):
        a = P(4, **kw).decode_block(blk)
        b = P(4, **kw).decode_block_host(blk)
        n = b.shape[1]
        assert n == 144 * 160 and a.shape[1] >= n
        assert not np.abs(a[:, n:]).any()
        peak = float(np.abs(b).max())
        gaps[name] = float(np.abs(a[:, :n] - b).max()) / peak
    assert abs(gaps["port"] - gaps["jax"]) <= 2e-3
    assert gaps["port"] < 3e-2       # chip_smoke.py's HOST_PCM_REL


def test_decode_block_host_empty_block(tables):
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    tp = BatchedP25VoicePipeline(C, device="cpu", tables=tables)
    x = np.zeros((C, 24000, 2), dtype=np.float32)
    out = tp.decode_block_host(x)
    assert out.shape == (C, 0) and out.dtype == np.float32


@pytest.mark.parametrize("seed", [5, 6])
def test_synth_multichannel_matches(jax_cpu, tables, seed):
    """The synthesis from float16 amplitudes: ``[C, F, 160]`` float16,
    within 2e-3 of the peak (the f16 output rounds to 2^-11 relative)."""
    import jax.numpy as jnp
    from dsdneo_tpu.engine.voicebatch import _synth_multichannel as jsyn
    from dsdneo_tpu_torch.engine.voicebatch import _synth_multichannel
    rng = np.random.default_rng(seed)
    Cn, F = 3, 18
    w0 = rng.uniform(0.05, 0.3, (Cn, F)).astype(np.float32)
    w0[:, 4] = 0.0                                  # a muted frame
    amps = rng.uniform(0, 0.2, (Cn, F, 56)).astype(np.float16)
    voiced = (rng.random((Cn, F, 56)) > 0.4).astype(np.float16)
    want = np.asarray(jsyn(jnp.asarray(w0), jnp.asarray(amps),
                           jnp.asarray(voiced)))
    got = _synth_multichannel(torch.from_numpy(w0), torch.from_numpy(amps),
                              torch.from_numpy(voiced), tables)
    assert got.dtype == torch.float16 and got.shape == want.shape
    g, w = got.numpy().astype(np.float32), want.astype(np.float32)
    peak = float(np.abs(w).max())
    np.testing.assert_allclose(g, w, atol=PCM_REL * peak)


# -- dsp/audio_filters.upsample_8k_to_48k ----------------------------------
@pytest.mark.parametrize("shape", [(1601,), (2, 800)])
def test_upsample_8k_to_48k(jax_cpu, shape):
    import jax.numpy as jnp
    from dsdneo_tpu.dsp.audio_filters import upsample_8k_to_48k as jup
    from dsdneo_tpu_torch.dsp.audio_filters import upsample_8k_to_48k
    x = np.random.default_rng(len(shape)).uniform(
        -0.8, 0.8, shape).astype(np.float32)
    want = np.asarray(jup(jnp.asarray(x)))
    got = upsample_8k_to_48k(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == shape[:-1] + (shape[-1] * 6,)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-6 * peak)


# -- on the card: K1 at make_frontend_step's shapes ------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("mode", FOUR_LEVEL)
def test_make_frontend_step_on_the_card(mode):
    """The step on the card (K1) against its CPU run (the plain version)
    at [4, 24000]: soft symbols within 2e-4, dibits equal off the
    thresholds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch.engine.batched import make_frontend_step
    x = _fsk_block(mode, 4, 24000, seed=7)
    cd, cs, cp = make_frontend_step(mode, 24000, device="cuda")(
        torch.from_numpy(x).cuda())
    hd, hs, hp = make_frontend_step(mode, 24000, device="cpu")(x)
    torch.cuda.synchronize()
    np.testing.assert_allclose(cs.cpu().numpy(), hs.numpy(), atol=SOFT_TOL)
    off = _off_threshold(hs.numpy())
    np.testing.assert_array_equal(cd.cpu().numpy()[off], hd.numpy()[off])
