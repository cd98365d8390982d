"""The gated front end of the PyTorch port against the JAX package's, on
the CPU (``engine/demod.gated_frontend_step`` and what it calls).

  - ``symbols.slicer``: the windowed 2%/98% quantiles, the levels and the
    dibits of ``estimate_levels`` / ``slice_dibits`` bit for bit
    (tolerance 0), four- and two-level, on random and on modulated
    symbols, with short captures (one window) and ragged tails;
  - ``symbols.timing.recover_symbols``: symbols and positions bit for bit
    (tolerance 0) on discriminator-like signals with a gated gap;
  - the power gate: ``jnp.abs(y) ** 2`` and the mask
    ``p > 0.02 · max`` equal on the same filtered signal, samples on the
    edge included;
  - ``dsp.firdes.channel_lpf``: the port's own design equals the JAX
    package's taps for every profile;
  - ``gated_frontend_step`` end to end on D-STAR- and M17-like bursts with
    dead air: the soft symbols within ``SOFT_TOL`` (0.1, a thirtieth of
    the outer level) of the JAX function's, most of them within 2e-4,
    and the dibits equal wherever the JAX symbol lies more than
    ``SOFT_TOL`` from a slicer threshold.  The FIR is a convolution in
    another summation order and PyTorch's discriminator atan2 rounds
    otherwise (~1e-6 apart); a timing window that is mostly dead air
    takes its phase from the noise, so that difference moves its phase
    and, through the interpolation of the phase between windows, the
    decision instants of its live neighbours.

The JAX functions run inside ``jax.jit``, as its pipelines call them.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")           # the card's machine has none
jnp = jax.numpy

from dsdneo_tpu.dsp import firdes as jfirdes
from dsdneo_tpu.dsp import frontend as jfrontend
from dsdneo_tpu.engine import demod as jdemod
from dsdneo_tpu.symbols import slicer as jslicer
from dsdneo_tpu.symbols import timing as jtiming
from dsdneo_tpu_torch.dsp import firdes as tfirdes
from dsdneo_tpu_torch.engine import demod as tdemod
from dsdneo_tpu_torch.symbols import slicer as tslicer
from dsdneo_tpu_torch.symbols import timing as ttiming

LEVELS = np.array([1.0, 3.0, -1.0, -3.0], np.float32)
SOFT_TOL = 0.1              # gated front end, soft symbols (see above)


def _symbols(rng, C, K, four_level, gap=True):
    """Noisy symbols of random amplitude and offset per channel, a zero
    run (a gated gap) in the middle when ``gap``."""
    lv = LEVELS if four_level else LEVELS[[1, 3]]
    s = (rng.choice(lv, size=(C, K)) * rng.uniform(0.3, 2.0, (C, 1))
         + rng.uniform(-0.5, 0.5, (C, 1))
         + rng.normal(scale=0.25, size=(C, K))).astype(np.float32)
    if gap:
        s[:, K // 3:K // 2] = 0.0
    return s


@pytest.mark.parametrize("K,four_level,modulated", [
    (14398, True, True), (14398, False, True), (3000, True, False),
    (1300, False, False), (300, True, True), (1025, False, True)])
def test_slicer_bit_for_bit(K, four_level, modulated):
    rng = np.random.default_rng(K + four_level)
    sym = (_symbols(rng, 3, K, four_level) if modulated
           else rng.normal(size=(3, K)).astype(np.float32))
    jl = jax.jit(functools.partial(jslicer.estimate_levels, win=512,
                                   four_level=four_level))
    js = jax.jit(functools.partial(jslicer.slice_dibits, win=512,
                                   four_level=four_level))
    wc, ws = (np.asarray(a) for a in jl(jnp.asarray(sym)))
    wd, wn = (np.asarray(a) for a in js(jnp.asarray(sym)))
    tc, tsc = tslicer.estimate_levels(torch.as_tensor(sym), 512)
    td, tn = tslicer.slice_dibits(torch.as_tensor(sym), 512, four_level)
    np.testing.assert_array_equal(tc.numpy(), wc)
    np.testing.assert_array_equal(tsc.numpy(), ws)
    np.testing.assert_array_equal(tn.numpy(), wn)
    np.testing.assert_array_equal(td.numpy(), wd)
    assert td.dtype == torch.uint8


@pytest.mark.parametrize("q", [0.02, 0.5, 0.98])
def test_quantile_equals_jnp_quantile(q):
    """The written-out linear quantile against ``jnp.quantile`` at the
    slicer's window and at a short one."""
    rng = np.random.default_rng(7)
    for win in (512, 37):
        a = rng.normal(size=(5, 4, win)).astype(np.float32)
        want = np.asarray(jax.jit(lambda x: jnp.quantile(x, q, axis=-1))(a))
        srt = torch.sort(torch.as_tensor(a), dim=-1).values
        np.testing.assert_array_equal(
            tslicer._quantile_sorted(srt, q).numpy(), want)


def _disc(rng, C, n, sps, gap=True):
    """Discriminator-like samples: a symbol-rate swing of random phase,
    noise, and a zeroed stretch as the power gate leaves it."""
    t = np.arange(n)
    d = np.stack([np.sin(2 * np.pi * t / (2 * sps) + rng.uniform(0, 6))
                  for _ in range(C)])
    d = (d * rng.uniform(0.2, 1.0, (C, 1))
         + 0.3 * rng.normal(size=(C, n))).astype(np.float32)
    if gap:
        d[:, n // 3:n // 2] = 0.0
    return d


@pytest.mark.parametrize("n,sps,gap", [(144000, 10.0, True),
                                       (30000, 10.0, True),
                                       (60000, 20.0, False),
                                       (4000, 10.0, True)])
def test_recover_symbols_bit_for_bit(n, sps, gap):
    """(4000, 10) holds one timing window, so the interpolation of the
    phase holds its one value everywhere."""
    rng = np.random.default_rng(n)
    d = _disc(rng, 2, n, sps, gap)
    K = int(n // sps) - 2
    f = jax.jit(functools.partial(jtiming.recover_symbols, sps=sps,
                                  win_symbols=256, max_symbols=K))
    ws, wp = (np.asarray(a) for a in f(jnp.asarray(d)))
    ts, tp = ttiming.recover_symbols(torch.as_tensor(d), sps,
                                     win_symbols=256, max_symbols=K)
    np.testing.assert_array_equal(tp.numpy(), wp)
    np.testing.assert_array_equal(ts.numpy(), ws)


def test_gate_power_and_mask_equal():
    """On the same filtered signal, with samples scaled far down (dead
    air; not so far that |y|² is subnormal, which XLA's CPU backend
    flushes to zero), far up, exactly zero, and some placed on the 2%
    edge."""
    rng = np.random.default_rng(11)
    y = (rng.normal(size=(3, 40000))
         + 1j * rng.normal(size=(3, 40000))).astype(np.complex64)
    y[:, :300] *= 1e-12
    y[:, 300:600] *= 1e-3
    y[:, 600:610] = 0
    y[:, 700:710] *= 1e15
    yt = torch.complex(torch.as_tensor(y.real.copy()),
                       torch.as_tensor(y.imag.copy()))
    want_p = np.asarray(jax.jit(lambda z: jnp.abs(z) ** 2)(jnp.asarray(y)))
    np.testing.assert_array_equal(tdemod.power(yt).numpy(), want_p)
    # put samples on the edge: scale a few so |y|² sits at the threshold
    edge = 0.02 * want_p.max(axis=-1, keepdims=True)
    idx = rng.integers(800, 40000, (3, 50))
    for c in range(3):
        y[c, idx[c]] *= np.sqrt(edge[c, 0] / want_p[c, idx[c]]).astype(
            np.float32)
    jm = jax.jit(lambda z: (lambda p: p > 0.02 * jnp.max(
        p, axis=-1, keepdims=True))(jnp.abs(z) ** 2))
    yt = torch.complex(torch.as_tensor(y.real.copy()),
                       torch.as_tensor(y.imag.copy()))
    np.testing.assert_array_equal(tdemod.gate_mask(yt).numpy(),
                                  np.asarray(jm(jnp.asarray(y))))


@pytest.mark.parametrize("profile", sorted(jfirdes.CH_LPF_CUTOFF_HZ))
def test_channel_lpf_equals_jax_package(profile):
    for fs in (48000.0, 96000.0):
        want = jfirdes.channel_lpf(fs, profile)
        got = tfirdes.channel_lpf(fs, profile)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _fsk_iq(rng, n_dib, sps, two_level, lead=300, dead=(1500, 2500)):
    """FM bursts: random symbols, dead air (zero I/Q) from ``dead[0]`` to
    ``dead[1]`` dibits, 30 dB noise; float32 planes ``[B, 2]``."""
    lv = (rng.choice([3.0, -3.0], n_dib) if two_level
          else rng.choice(LEVELS.astype(np.float64), n_dib))
    inst = np.repeat(lv / 3.0, sps) * 0.25
    x = np.exp(1j * np.pi * np.cumsum(inst))
    x[dead[0] * sps:dead[1] * sps] = 0
    x[:lead * sps] = 0
    x = x + (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)) \
        * 10 ** (-30 / 20)
    return np.stack([x.real, x.imag], -1).astype(np.float32)


@pytest.mark.parametrize("mode", ["dstar", "m17"])
def test_gated_frontend_step_matches_jax(mode):
    four_level = mode == "m17"
    profile = "6k25" if mode == "dstar" else "12k5"
    sps = 10.0
    rng = np.random.default_rng(5)
    iq = np.stack([_fsk_iq(rng, 4000, 10, not four_level) for _ in range(2)])
    n_sym = int(iq.shape[1] // sps) - 2
    taps = jfirdes.channel_lpf(48000.0, profile)
    f = jax.jit(functools.partial(jdemod.gated_frontend_step, sps=sps,
                                  n_sym=n_sym, four_level=four_level))
    wd, ws = (np.asarray(a) for a in f(jnp.asarray(iq), jnp.asarray(taps)))
    td, ts = tdemod.gated_frontend_step(torch.as_tensor(iq),
                                        torch.as_tensor(taps), sps, n_sym,
                                        four_level)
    assert td.shape == (2, n_sym) and td.dtype == torch.uint8
    np.testing.assert_allclose(ts.numpy(), ws, rtol=0, atol=SOFT_TOL)
    assert (np.abs(ts.numpy() - ws) <= 2e-4).mean() > 0.9
    thr = np.array([0.0, 2.0, -2.0] if four_level else [0.0], np.float32)
    off = (np.abs(ws[..., None] - thr).min(axis=-1) > SOFT_TOL)
    assert off.mean() > 0.6         # a third of the block is dead air
    np.testing.assert_array_equal(td.numpy()[off], wd[off])
    # the gate did its work: the dead air sliced from zeroed samples
    jy = np.asarray(jfrontend.fir_complex(
        jnp.asarray(iq[..., 0] + 1j * iq[..., 1]), jnp.asarray(taps)))
    assert not tdemod.gate_mask(torch.as_tensor(jy.copy())).numpy()[
        :, 1700 * 10:2300 * 10].any()
