"""The wideband front of the PyTorch port against the JAX package's, on
the CPU: ``dsp/frontend``'s CU8 widen, fs/4 rotation, real FIR, halfband
decimator and DC blocker; ``dsp/channelizer`` (the prototype taps, the
critically sampled and the 2x-oversampled banks, the channel centres);
the fleet's row extractor (``engine/fleettrunk.make_row_extractor``)
with its integer NCO; ``engine/wideband`` (``channelize_band``,
``decode_wideband``, ``decode_wideband_voice_batched``).

Tolerances, measured here and stated per test: the taps, the centres,
the NCO phase, the widen, the rotation and the DC blocker are bit for
bit; the banks differ from XLA's by the FFT's rounding (``torch.fft``
and XLA's FFT round differently: at most 2.2e-7 of the output's peak
measured, held to 1e-6), the halfband by the FIR's summation order
(7.3e-7 of the peak, held to 2e-6), the extracted rows by both (held to
2e-6 of the peak).  The JAX functions run under ``jax.jit``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has none
import jax.numpy as jnp

from dsdneo_tpu.dsp import channelizer as JC, firdes as jfd, frontend as JF
from dsdneo_tpu.engine import fleettrunk as JT, wideband as JW
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.dsp import channelizer as PC, frontend as PF
from dsdneo_tpu_torch.engine import fleettrunk as PT, fleetvec as FV
from dsdneo_tpu_torch.engine import serialvec as SV, wideband as PW
from dsdneo_tpu_torch.protocol.p25 import encode as PE

FS = 768000.0
N_CH = 16


def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)
            ).astype(np.complex64)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


def test_taps_bit_for_bit():
    for args in ((16, 8, 0.5), (16, 12, 0.5), (16, 16, 0.75), (50, 12, 0.5),
                 (256, 12, 0.5), (4, 64, 0.75)):
        np.testing.assert_array_equal(PC.prototype_taps(*args),
                                      JC.prototype_taps(*args))
    hb = jfd.lowpass_taps(62, 2.0, 0.5, window="blackman-harris")
    np.testing.assert_array_equal(PT.halfband_taps(), hb.astype(np.float32))


@pytest.mark.parametrize("n_ch", [16, 50, 256])
def test_channel_frequencies_exact(n_ch):
    np.testing.assert_array_equal(PC.channel_frequencies(n_ch, n_ch * 48e3),
                                  JC.channel_frequencies(n_ch, n_ch * 48e3))


@pytest.mark.parametrize("fn,args", [("channelize", (16, 12)),
                                     ("channelize", (50, 8)),
                                     ("channelize_os2", (16, 12)),
                                     ("channelize_os2", (16, 16, 0.75)),
                                     ("channelize_os2", (50, 12))])
def test_banks_within_fft_rounding(fn, args):
    x = _noise(args[0] * 3001 + 7, 1)
    want = np.asarray(jax.jit(lambda v: getattr(JC, fn)(v, *args))(
        jnp.asarray(x)))
    got = getattr(PC, fn)(torch.from_numpy(x), *args).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    assert _rel(want, got) <= 1e-6


def test_frontend_helpers():
    x = _noise((3, 4001), 2)
    hb = PT.halfband_taps()
    want = np.asarray(jax.jit(lambda v: JF.decimate2_halfband(
        v, jnp.asarray(hb)))(jnp.asarray(x)))
    got = PF.decimate2_halfband(torch.from_numpy(x), torch.from_numpy(hb))
    assert got.shape == want.shape and _rel(want, got.numpy()) <= 2e-6
    taps = jfd.lowpass_taps(64, 48000.0, 3400.0)
    want = np.asarray(jax.jit(lambda v: JF.fir_real(v, jnp.asarray(taps)))(
        jnp.asarray(x.real)))
    got = PF.fir_real(torch.from_numpy(x.real.copy()), torch.from_numpy(taps))
    assert _rel(want, got.numpy()) <= 2e-6
    raw = np.random.default_rng(3).integers(0, 256, (3, 4000)).astype(
        np.uint8)
    np.testing.assert_array_equal(
        PF.widen_cu8(torch.from_numpy(raw)).numpy(),
        np.asarray(jax.jit(JF.widen_cu8)(jnp.asarray(raw))))
    for sign in (1, -1):
        np.testing.assert_array_equal(
            PF.fs4_rotate(torch.from_numpy(x), sign).numpy(),
            np.asarray(jax.jit(lambda v: JF.fs4_rotate(v, sign))(
                jnp.asarray(x))))
    np.testing.assert_array_equal(
        PF.dc_block(torch.from_numpy(x + 0.3 - 0.1j)).numpy(),
        np.asarray(jax.jit(JF.dc_block)(jnp.asarray(x + 0.3 - 0.1j))))


def _jax_phase(offs, n):
    """The JAX extractor's NCO phase (``fleettrunk.py:88-96``), jitted."""
    def f(o):
        kidx = jnp.round(o / 48000.0).astype(jnp.int32)
        res = o - kidx * jnp.int32(48000)
        nn = jnp.arange(n, dtype=jnp.int32)
        a, b = nn // 8192, nn % 8192
        r1 = jnp.mod(8192 * res, 96000)[:, None]
        rm = jnp.mod(res, 96000)[:, None]
        return kidx, jnp.mod(jnp.mod(a[None, :] * r1, 96000)
                             + b[None, :] * rm, 96000)
    k, ph = jax.jit(f)(jnp.asarray(offs, jnp.int32))
    return np.asarray(k), np.asarray(ph)


def test_nco_phase_exact():
    offs = np.array([0, 1, -1, 23999, 24000, -24000, 24001, 72000, -72000,
                     137531, -201250, 360000, -383999], np.int32)
    n = 3 * 8192 + 123
    k, ph = PT.nco_phase(torch.from_numpy(offs), n)
    jk, jph = _jax_phase(offs, n)
    np.testing.assert_array_equal(k.numpy(), jk)
    np.testing.assert_array_equal(ph.numpy(), jph)
    with pytest.raises(ValueError):
        PT.nco_phase(torch.tensor([0], dtype=torch.int32), 8192 * 22370 + 1)


def test_row_extractor_exact_nco():
    """A pure tone at an integer-Hz offset extracts to (near) DC on its
    row over a 2 s block, and new offsets retarget the same extractor
    (the JAX package's test, on the port)."""
    n = int(2 * FS)
    t = np.arange(n) / FS
    f1, f2 = 137_531, -201_250
    wide = (np.exp(2j * np.pi * f1 * t)
            + np.exp(2j * np.pi * f2 * t)).astype(np.complex64)
    ex = PT.make_row_extractor(N_CH)
    for offs in ([f1, f2], [f2, f1]):
        rows = ex(torch.from_numpy(wide),
                  torch.tensor(offs, dtype=torch.int32)).numpy()
        for r in range(2):
            x = rows[r][2000:-2000]
            dphi = np.angle(x[1:] * np.conj(x[:-1]))
            assert abs(np.mean(dphi)) * 48000 / (2 * np.pi) < 1.0, r
            assert np.abs(x).mean() > 0.1, r


@pytest.mark.parametrize("form", ["complex", "planes", "cu8"])
def test_row_extractor_against_jax(form):
    x = _noise(int(0.25 * FS), 4) * 0.3
    if form == "complex":
        wj = wp = x
    else:
        pl = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
        if form == "cu8":
            pl = np.clip(pl / np.abs(pl).max() * 127.5 + 127.5, 0,
                         255).astype(np.uint8)
        wj = wp = pl
    offs = np.array([-96000, 150000, 24000, -383999, 0], np.int32)
    want = np.asarray(JT.make_row_extractor(N_CH)(jnp.asarray(wj),
                                                  jnp.asarray(offs)))
    got = PT.make_row_extractor(N_CH)(torch.from_numpy(wp),
                                      torch.from_numpy(offs)).numpy()
    assert got.shape == want.shape
    assert _rel(want, got) <= 2e-6


def _voice_band(seconds=2, loaded=(2, -5)):
    """P25 voice of the p25p1 vector on channels ``loaded`` of a 16-bin
    768 kHz band, each with its own lead and noise."""
    tv = params.load("cpu").test_vector()
    n_dib = seconds * 4800
    parts = [(PE.c4fm_iq(PE.vector_stream(tv, 40 + 17 * i, n_dib), seed=i),
              k * 48000) for i, k in enumerate(loaded)]
    return FV.place(parts, FS, int(seconds * FS)).numpy()


def test_channelize_band_and_decode_wideband():
    wide = _voice_band()
    ch_j, f_j = JW.channelize_band(wide, FS)
    ch_p, f_p = PW.channelize_band(wide, FS, device="cpu")
    np.testing.assert_array_equal(f_p, f_j)
    assert ch_p.shape == ch_j.shape and _rel(ch_j, ch_p) <= 2e-6
    res_j = JW.decode_wideband(wide, FS, mode="p25p1")
    res_p = PW.decode_wideband(wide, FS, mode="p25p1", device="cpu")
    assert [(r.index, r.freq_hz) for r in res_p] == \
        [(r.index, r.freq_hz) for r in res_j]
    assert {r.index for r in res_p} == {2, 16 - 5}
    for a, b in zip(res_j, res_p):
        assert abs(a.power_db - b.power_db) < 1e-3
        assert SV.events_equal(a.ctx.events, b.ctx.events) is None
        assert sum("LDU" in e.line for e in b.ctx.events) >= 8
    with pytest.raises(ValueError):
        PW.channelize_band(wide[:1000], 48000.0, device="cpu")


def test_decode_wideband_voice_batched_against_jax():
    wide = _voice_band()
    n = int(FS)
    pj, fj = JW.decode_wideband_voice_batched(wide[:n], FS, N_CH)
    pp, fp = PW.decode_wideband_voice_batched(wide[:n], FS, N_CH,
                                              device="cpu")
    np.testing.assert_array_equal(fp, fj)
    pj = np.asarray(pj)
    assert pp.shape == pj.shape and pj.shape[1] > 0
    assert np.abs(pp - pj).max() <= 2e-3 * np.abs(pj).max()
    energy = np.abs(pp).mean(axis=1)
    assert set(np.flatnonzero(energy > 1e-3)) == {2, 16 - 5}


def test_entry_points_take_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        PW.channelize_band(_noise(8000, 5), FS)
    with pytest.raises(RuntimeError):
        PT.TrunkedFleet(FS, [0], 1)


def test_extractor_dip_pinned_in_both():
    """The JAX bank (branch i's taps over x[mN + i]) gives the row
    extractor a dip 9-19 kHz off a bin's centre (-19.6 dB at 14 kHz on
    16 bins, -29 dB on 50), and the wideband bank folds what lies off a
    bin's centre into the bins two away (ROADMAP queue 3): the port's
    gains equal the JAX package's."""
    n = int(0.1 * FS)
    t = np.arange(n) / FS
    ex_j, ex_p = JT.make_row_extractor(N_CH), PT.make_row_extractor(N_CH)
    gains = []
    for res in (0, 8000, 14000, -16000):
        off = 5 * 48000 + res
        x = np.exp(2j * np.pi * off * t).astype(np.complex64)
        o = np.array([off], np.int32)
        gj = np.abs(np.asarray(ex_j(jnp.asarray(x), jnp.asarray(o)))[0,
                                                                    400:-400])
        gp = ex_p(torch.from_numpy(x), torch.from_numpy(o))[0, 400:-400]
        gains.append((gj.mean(), float(gp.abs().mean())))
    db_j = [20 * np.log10(g[0] / gains[0][0]) for g in gains]
    db_p = [20 * np.log10(g[1] / gains[0][1]) for g in gains]
    np.testing.assert_allclose(db_p, db_j, atol=1e-3)
    assert -3 < db_p[1] < -1.5 and db_p[2] < -15 and db_p[3] < -8
    # the wideband bank: a tone 3 kHz above bin 6's centre appears in
    # bins 4 and 8 at about -24 dB, in both packages
    x = np.exp(2j * np.pi * (6 * 48000 + 3000) * t).astype(np.complex64)
    fold = []
    for ch in (JW.channelize_band(x, FS)[0],
               PW.channelize_band(x, FS, device="cpu")[0]):
        p = (np.abs(ch[:, 100:-100]) ** 2).mean(axis=1)
        fold.append(10 * np.log10(p[[4, 8]] / p[6]))
    np.testing.assert_allclose(fold[1], fold[0], atol=1e-3)
    assert (fold[1] > -30).all()
