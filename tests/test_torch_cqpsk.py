"""The CQPSK front end of the PyTorch port against the JAX package.

The same seeded π/4-DQPSK blocks go through ``dsdneo_tpu.dsp.cqpsk`` /
``dsdneo_tpu.symbols.timing`` and their counterparts in the port, both
on the CPU.  The JAX functions run inside ``jax.jit``, as the JAX
pipeline runs them: XLA folds their constants there (a division by a
constant becomes a product with its reciprocal), and where a float32
phase reaches 10^4 radians that decides the rounding; the port writes
the folded form.

Soft-symbol bound.  The port reproduces the order of every product, so
99.9% of the soft symbols agree to 1e-5; the rest differ by up to a few
1e-3, where XLA's and PyTorch's ``cos``/``sin`` reduce a float32 argument
of thousands of radians differently.  The bound asserted is 5e-3 on the
±1/±3 alphabet, and dibits are compared where the JAX soft symbol is
farther than that from the slicer's thresholds 0 and ±2.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has none
import jax.numpy as jnp

from dsdneo_tpu.dsp import cqpsk as jcq
from dsdneo_tpu.dsp import firdes as jfirdes
from dsdneo_tpu.symbols import timing as jtiming
from dsdneo_tpu_torch.dsp import cqpsk as tcq
from dsdneo_tpu_torch.dsp import firdes as tfirdes
from dsdneo_tpu_torch.symbols import timing as ttiming

FS, RS = 48000.0, 4800.0
SPS = 10
SOFT_TOL = 5e-3


def _pi4dqpsk(n_sym, f0_hz, slope_hz_s, seed, noise=0.03):
    """Seeded π/4-DQPSK at RS sym/s, RRC-shaped, on a carrier
    f(t) = f0 + slope·t, with white noise; returns (x, levels)."""
    rng = np.random.default_rng(seed)
    lv = rng.choice([-3, -1, 1, 3], size=n_sym)
    n = n_sym * SPS + 16 * SPS
    x = np.zeros(n, np.complex128)
    x[np.arange(n_sym) * SPS + 8 * SPS] = np.exp(1j * np.cumsum(lv * np.pi / 4))
    x = np.convolve(x, tfirdes.rrc(SPS, 8 * SPS | 1, 0.2), mode="same")
    t = np.arange(n) / FS
    x = x * np.exp(2j * np.pi * (f0_hz * t + 0.5 * slope_hz_s * t * t))
    x = x + noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return x.astype(np.complex64), lv


def _accuracy(soft, lv):
    """Best share of symbols sliced to ``lv`` over the first 20 lags."""
    sl = np.clip(np.round((np.asarray(soft) + 3) / 2) * 2 - 3, -3, 3)
    best = 0.0
    for off in range(20):
        m = min(len(sl) - off, len(lv))
        best = max(best, float(np.mean(sl[off:off + m] == lv[:m])))
    return best


@pytest.mark.parametrize("sps,ntaps,alpha", [(10, 81, 0.2), (10.0, 80, 0.2),
                                            (8, 65, 0.35), (5, 41, 0.25)])
def test_rrc_equals_jax_package(sps, ntaps, alpha):
    """The port's own copy of the RRC design; (5, 41, 0.25) has taps on
    the 1/(4α) singularity."""
    got = tfirdes.rrc(sps, ntaps, alpha)
    want = jfirdes.rrc(sps, ntaps, alpha)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["inside", "ends", "repeated", "one_point"])
def test_interp_matches_jnp_interp(case):
    """Bit-equal to ``jnp.interp`` mapped over rows: inside the points,
    clamped to the end values outside them, on repeated queries and
    queries that sit on a point, and with a single point."""
    rng = np.random.default_rng(3)
    W = 1 if case == "one_point" else 9
    xp = ((np.arange(W) + 0.5) * 1280.0).astype(np.float32)
    fp = rng.normal(size=(3, W)).astype(np.float32)
    x = {"inside": rng.uniform(xp[0], xp[-1] + 1, 200),
         "ends": np.array([-50.0, 0.0, xp[0], xp[-1], xp[-1] + 1, 1e6]),
         "repeated": np.repeat(xp[:5] if W > 1 else xp, 3),
         "one_point": np.array([0.0, 640.0, 5000.0])}[case].astype(np.float32)
    want = np.asarray(jax.vmap(lambda f: jnp.interp(jnp.asarray(x),
                                                    jnp.asarray(xp), f))(
        jnp.asarray(fp)))
    got = ttiming.interp(torch.as_tensor(x), torch.as_tensor(xp),
                         torch.as_tensor(fp)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("win,n_sym,seed", [(128, 3000, 0), (64, 3000, 1),
                                           (256, 1500, 2), (512, 600, 3)])
def test_decision_positions_match(win, n_sym, seed):
    """Positions within 1e-3 samples, or one float32 step where the
    position is large (2e-3 at sample 30,000); (512, 600) has a single window, so
    ``interp`` clamps everywhere, and every case's tail runs into the
    clip at n - 2."""
    rng = np.random.default_rng(seed)
    x, _ = _pi4dqpsk(n_sym, 0.0, 0.0, seed)
    e = np.stack([np.abs(x) ** 2,
                  np.abs(np.roll(x, 3)) ** 2 + 0.01 * rng.random(len(x))]
                 ).astype(np.float32)
    K = n_sym + 16
    jf = jax.jit(functools.partial(jtiming.decision_positions, sps=10.0,
                                   win_symbols=win, max_symbols=K))
    want = np.asarray(jf(jnp.asarray(e)))
    got = ttiming.decision_positions(torch.as_tensor(e), 10.0,
                                     win_symbols=win, max_symbols=K).numpy()
    assert got.shape == want.shape == (2, K)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=2.0 ** -23)
    assert got.max() <= e.shape[1] - 2.0 and got.min() >= 0.0


@pytest.mark.parametrize("seed", range(6))
def test_estimate_cfo_picks_the_same_bin(seed):
    """Carrier offsets spread over ±500 Hz (the search takes ±600): the
    masked argmax picks the same FFT bin, so the estimates are equal to
    float32 rounding of one formula (1e-3 Hz; the bins lie 0.083 Hz
    apart in CFO).  Two bins can only tie if their magnitudes are equal
    to the bit; both packages then take the lower bin, and a near-tie
    that the two FFTs' rounding resolved differently would show here as
    a difference of one bin, which the seeds do not produce."""
    rng = np.random.default_rng(100 + seed)
    cfo = rng.uniform(-500.0, 500.0, size=2)
    x = np.stack([_pi4dqpsk(14384, f, 0.0, 10 * seed + c)[0]
                  for c, f in enumerate(cfo)])
    jf = jax.jit(functools.partial(jcq.estimate_cfo_qpsk, fs=FS,
                                   symbol_rate=RS))
    want = np.asarray(jf(jnp.asarray(x)))
    got = tcq.estimate_cfo_qpsk(torch.as_tensor(x), FS, RS).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, cfo, atol=0.5)


def test_estimate_cfo_windowed_and_pull_in():
    x = np.stack([_pi4dqpsk(9000, f, 0.0, 7 + c)[0]
                  for c, f in enumerate((-80.0, 240.0))])
    for kw in ({"n_windows": 8}, {"n_windows": 5, "pull_in_hz": 300.0}):
        jf = jax.jit(functools.partial(jcq.estimate_cfo_qpsk_windowed, fs=FS,
                                       symbol_rate=RS, **kw))
        want = np.asarray(jf(jnp.asarray(x)))
        got = tcq.estimate_cfo_qpsk_windowed(torch.as_tensor(x), FS, RS,
                                             **kw).numpy()
        assert got.shape == want.shape == (2, kw["n_windows"])
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


DEMOD_CASES = {
    "default": ({}, 200.0, 0.0),
    "windows8": ({"cfo_windows": 8}, -431.7, 0.0),
    "windows8_drift": ({"cfo_windows": 8}, -150.0, 100.0),
    "prior": ({"cfo_prior": 100.0, "cfo_alpha": 0.7}, 55.5, 0.0),
    "windows4_prior": ({"cfo_windows": 4, "cfo_prior": -50.0,
                        "cfo_alpha": 0.5}, -90.0, 0.0),
    "ted_half": ({"ted_gain": 0.5}, 310.0, 0.0),
    "ted_two": ({"ted_gain": 2.0}, -20.0, 0.0),
    "n_sym_pull_in": ({"n_sym": 14000, "pull_in_hz": 400.0,
                       "rrc_alpha": 0.25}, 333.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(DEMOD_CASES))
def test_demod_cqpsk_matches(case):
    """A 3 s block (the pipeline's length, where the de-rotation phase is
    largest) on two channels: carrier estimates equal (1e-3 Hz), soft
    symbols within SOFT_TOL, 99% of them within 1e-5, and equal dibits
    wherever the JAX soft symbol is clear of a threshold."""
    kw, f0, slope = DEMOD_CASES[case]
    x = np.stack([_pi4dqpsk(14384, f0 + 17.0 * c, slope, 31 + c)[0]
                  for c in range(2)])
    jf = jax.jit(functools.partial(jcq.demod_cqpsk, fs=FS, symbol_rate=RS,
                                   **kw))
    jsoft, jcfo = (np.asarray(a) for a in jf(jnp.asarray(x)))
    tsoft, tcfo = (a.numpy() for a in tcq.demod_cqpsk(torch.as_tensor(x),
                                                      FS, RS, **kw))
    assert tsoft.shape == jsoft.shape and tsoft.dtype == np.float32
    np.testing.assert_allclose(tcfo, jcfo, atol=1e-3, rtol=0)
    err = np.abs(tsoft - jsoft)
    assert err.max() <= SOFT_TOL, err.max()
    assert np.mean(err <= 1e-5) >= 0.99
    clear = np.min(np.abs(jsoft[..., None] - np.array([-2.0, 0.0, 2.0])),
                   axis=-1) > SOFT_TOL
    assert clear.mean() > 0.99
    lv = lambda s: np.clip(np.round((s + 3) / 2) * 2 - 3, -3, 3)
    np.testing.assert_array_equal(lv(tsoft)[clear], lv(jsoft)[clear])


# -- the contract of tests/test_cqpsk_drift.py, on the port -------------------
def _ramp(slope, seed=7):
    """9000 symbols on a carrier ramp centred on 0 Hz, so it stays
    inside the ±Rs/8 pull-in."""
    k = 9000
    return _pi4dqpsk(k, -slope * (k / RS) / 2.0, slope, seed, noise=0.0)


def test_windowed_cfo_tracks_drift_ramp():
    """600 Hz/s: the whole-block estimate degrades, eight windows recover
    the symbols."""
    x, lv = _ramp(600.0)
    xt = torch.as_tensor(x[None])
    soft1, _ = tcq.demod_cqpsk(xt, FS, RS, cfo_windows=1)
    soft8, _ = tcq.demod_cqpsk(xt, FS, RS, cfo_windows=8)
    assert _accuracy(soft1[0], lv) < 0.95
    assert _accuracy(soft8[0], lv) > 0.995


def test_windowed_cfo_no_regression_on_static_carrier():
    """A constant 200 Hz offset decodes through both paths."""
    x, lv = _pi4dqpsk(9000, 200.0, 0.0, 7, noise=0.0)
    xt = torch.as_tensor(x[None])
    soft1, cfo1 = tcq.demod_cqpsk(xt, FS, RS, cfo_windows=1)
    soft8, cfo8 = tcq.demod_cqpsk(xt, FS, RS, cfo_windows=8)
    assert _accuracy(soft1[0], lv) > 0.999
    assert _accuracy(soft8[0], lv) > 0.999
    assert abs(float(cfo1[0]) - 200.0) < 10.0
    assert abs(float(cfo8[0]) - 200.0) < 10.0


def test_fir_complex_restores_the_tf32_switch():
    """``fir_complex`` is full float32 on either device by itself and
    leaves the process's cuDNN TF32 switch as it found it."""
    from dsdneo_tpu_torch.dsp.frontend import fir_complex
    x, _ = _pi4dqpsk(300, 100.0, 0.0, 1)
    taps = torch.as_tensor(tfirdes.rrc(SPS, 81, 0.2))
    before = torch.backends.cudnn.allow_tf32
    y = fir_complex(torch.as_tensor(x[None]), taps).numpy()
    assert torch.backends.cudnn.allow_tf32 == before
    want = np.convolve(x.astype(np.complex128), taps.numpy().astype(
        np.float64), mode="same")
    np.testing.assert_allclose(y[0], want, atol=1e-5)
