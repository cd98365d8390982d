"""The decoded-audio filters of the PyTorch port against the JAX package's
(``dsp/audio_filters.py`` and the CLI's ``_condition_audio``), on the
CPU.

  - kernel K8's plain version (``one_pole`` on CPU tensors) behind
    ``deemphasis``, ``dc_block``, ``audio_lpf`` and ``audio_hpf``, bit
    for bit against the jitted JAX functions (tolerance 0), on random
    audio with a silent stretch (the state decays into the subnormal
    range, which both flush to zero), a ragged length, a step and other
    coefficients;
  - ``fma_f32_rn`` against the exactly rounded ``a·b + c``;
  - ``condition_audio`` against ``cli._condition_audio`` for every
    de-emphasis curve, low-pass and gain, bit for bit, and with both
    filters on (the cascade) against the JAX de-emphasis then low-pass
    in one ``jax.jit``, on audio whose silent stretch decays into the
    flushed subnormals;
  - ``condition_audio`` and ``one_pole`` with a carried state over
    successive blocks against one call on their concatenation, bit for
    bit (the state is the port's own: the JAX filters start from zero
    on every call);
  - the host classes (``AutoGain``, ``AudioGate``, ``AudioConcealer``):
    equal outputs and state over a sequence of blocks.
"""

from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")           # the card's machine has none
jnp = jax.numpy

from dsdneo_tpu.cli import _condition_audio  # noqa: E402
from dsdneo_tpu.dsp import audio_filters as J  # noqa: E402
from dsdneo_tpu_torch.dsp import audio_filters as P  # noqa: E402

FILTERS = ("deemphasis", "dc_block", "audio_lpf", "audio_hpf")


def _audio(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "silence":
        x = (rng.normal(size=(4, 2000)) * 0.3).astype(np.float32)
        x[:, 700:1900] = 0.0
    elif kind == "ragged":
        x = (rng.normal(size=(3, 1037)) * 0.05).astype(np.float32)
    else:                               # a step and a tone
        t = np.arange(1500)
        x = np.stack([np.where(t > 200, 0.7, 0.0),
                      0.4 * np.sin(0.3 * t)]).astype(np.float32)
    return x


@pytest.mark.parametrize("kind", ["silence", "ragged", "step"])
@pytest.mark.parametrize("name", FILTERS)
def test_filters_equal_the_jax_functions(name, kind):
    x = _audio(kind)
    want = np.asarray(jax.jit(getattr(J, name))(jnp.asarray(x)))
    got = getattr(P, name)(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    if kind == "silence" and name in ("deemphasis", "audio_lpf"):
        # the decay reaches zero where the JAX package flushes it
        assert (want[:, 1899] == 0).any()


@pytest.mark.parametrize("name, kw", [
    ("deemphasis", {"tau_us": 50.0}), ("deemphasis", {"tau_us": 75.0}),
    ("deemphasis", {"fs": 48000.0, "tau_us": 750.0}),
    ("audio_lpf", {"fc": 2500.0}), ("audio_hpf", {"fc": 120.0}),
    ("dc_block", {"fc": 10.0})])
def test_filter_coefficients_equal_the_jax_functions(name, kw):
    x = _audio("ragged")
    want = np.asarray(jax.jit(lambda v: getattr(J, name)(v, **kw))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(
        getattr(P, name)(torch.as_tensor(x), **kw).numpy(), want)


def _exact_f32(a, b, c) -> np.float32:
    """``a·b + c`` rounded once to float32, to nearest, ties to even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(r, np.float32(-np.inf)), r,
                 np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - exact)
        key = (d, int(np.asarray(cand).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def test_fma_f32_rn_rounds_once():
    rng = np.random.default_rng(3)
    a = rng.normal(size=600).astype(np.float32)
    b = (rng.normal(size=600) * np.exp2(rng.integers(-30, 30, 600))
         ).astype(np.float32)
    c = (rng.normal(size=600) * np.exp2(rng.integers(-40, 40, 600))
         ).astype(np.float32)
    c[:200] = -(a[:200] * b[:200])     # near-total cancellation
    got = P.fma_f32_rn(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    want = np.array([_exact_f32(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("deemph", ["", "off", "50", "75", "nfm"])
@pytest.mark.parametrize("lpf, gain", [(0, 0.0), (3400, 0.0), (2500, 40.0)])
def test_condition_audio_equals_the_cli(deemph, lpf, gain):
    x = _audio("silence")
    cfg = SimpleNamespace(deemph=deemph, audio_lpf_hz=lpf)
    want = np.asarray(_condition_audio(x.copy(), cfg, gain=gain),
                      np.float32)
    got = P.condition_audio(torch.as_tensor(x), deemph, lpf, gain)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("deemph, tau", [("50", 50.0), ("75", 75.0),
                                         ("nfm", 750.0)])
@pytest.mark.parametrize("lpf", [3400, 2500])
def test_condition_audio_cascade_equals_the_jitted_filters(deemph, tau, lpf):
    """Both filters on (the cascade: ``one_pole_plain`` twice on the CPU)
    against the JAX de-emphasis then low-pass inside one ``jax.jit``."""
    x = _audio("silence")
    want = np.asarray(jax.jit(lambda v: J.audio_lpf(
        J.deemphasis(v, fs=8000.0, tau_us=tau), fs=8000.0, fc=float(lpf)))(
        jnp.asarray(x)))
    got = P.condition_audio(torch.as_tensor(x), deemph, lpf)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the silent stretch decays through the subnormals to flushed zeros
    assert (want[:, 1899] == 0).any()


@pytest.mark.parametrize("deemph, lpf, diff", [
    ("nfm", 3400, False), ("75", 0, False), ("", 2500, False),
    ("", 0, True)])
def test_carried_state_equals_one_call_on_the_concatenation(deemph, lpf,
                                                             diff):
    """Blocks of 700, 1 and 1299 samples with the state carried: the
    cascade, each filter alone, and the DC block (``one_pole`` with
    ``diff``) equal one call on the whole rows; the state holds the last
    ``y`` (and the cascade's second filter's)."""
    x = torch.as_tensor(_audio("silence"))
    if diff:
        a = P.lowpass_pole(8000.0, 30.0)
        want = P.one_pole(x, a, diff=True)
        run = lambda blk, st: P.one_pole(blk, a, diff=True,  # noqa: E731
                                         state=st)
    else:
        want = P.condition_audio(x, deemph, lpf)
        run = lambda blk, st: P.condition_audio(  # noqa: E731
            blk, deemph, lpf, state=st)
    state = torch.zeros((x.shape[0], 2), dtype=torch.float32)
    got = torch.cat([run(x[:, i:j], state)
                     for i, j in ((0, 700), (700, 701), (701, 2000))], 1)
    assert torch.equal(got, want)
    whole = torch.zeros_like(state)
    run(x, whole)
    assert torch.equal(state, whole)
    assert run(x[:, :0], state).shape == (x.shape[0], 0)
    assert torch.equal(state, whole)            # an empty block: no step


def test_host_classes_equal_the_jax_package():
    rng = np.random.default_rng(9)
    blocks = [(rng.normal(size=160) * s).astype(np.float32)
              for s in (0.5, 0.02, 0.0, 0.003, 0.2, 0.001, 0.0, 0.0, 0.4)
              for _ in range(3)]
    pairs = ((J.AutoGain(), P.AutoGain()),
             (J.AutoGain(0.3, 10.0, 0.5), P.AutoGain(0.3, 10.0, 0.5)))
    for j, t in pairs:
        for blk in blocks:
            np.testing.assert_array_equal(t.apply(blk), j.apply(blk))
        assert t.gain == j.gain
    j, t = J.AudioGate(hang_frames=3), P.AudioGate(hang_frames=3)
    for blk in blocks + [np.zeros(0, np.float32)]:
        np.testing.assert_array_equal(t.process(blk), j.process(blk))
        assert (t.open, t._below) == (j.open, j._below)
    j, t = J.AudioConcealer(max_repeats=2), P.AudioConcealer(max_repeats=2)
    for blk in (None, blocks[0], None, None, None, blocks[4][:100], blocks[5]):
        np.testing.assert_array_equal(t.feed(blk, 160), j.feed(blk, 160))
        assert (t.concealed, t._repeats) == (j.concealed, j._repeats)
