"""The batched analog NBFM voice decode (``engine/analogbatch``) of the
PyTorch port against the JAX package's, on the CPU: three channels of
1 s at 48 kHz (a 1 kHz tone at 2.5 kHz deviation, the same tone with
noise at 20 dB, and noise without a carrier), as complex rows and as
float planes, through ``analog_voice_decode`` (the JAX function under
``jax.jit``) and ``BatchedAnalogVoicePipeline.decode_block``.  The PCM
agrees within 2e-3 of its peak; the squelched row is silent in both.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has none
import jax.numpy as jnp

from dsdneo_tpu.engine import analogbatch as J
from dsdneo_tpu_torch.engine import analogbatch as P

FS = 48000.0


def _rows(n=48000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    tone = np.exp(1j * 2 * np.pi * 2500.0
                  * np.cumsum(np.sin(2 * np.pi * 1000.0 * t)) / FS)
    noise = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))) / 2
    return np.stack([tone, tone + 0.1 * noise[0], noise[1]]).astype(
        np.complex64)


def _check(want, got):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    assert not want[2].any() and not got[2].any()
    assert np.abs(got[:2]).mean(axis=1).min() > 1e-2


@pytest.mark.parametrize("planes", [False, True])
def test_analog_voice_decode_against_jax(planes):
    x = _rows()
    if planes:
        x = np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    want = jax.jit(J.analog_voice_decode)(jnp.asarray(x))
    _check(want, P.analog_voice_decode(torch.from_numpy(x)).numpy())


def test_pipeline_decode_block_against_jax():
    x = _rows(seed=1)
    want = J.BatchedAnalogVoicePipeline(3).decode_block(x)
    pipe = P.BatchedAnalogVoicePipeline(3, device="cpu")
    _check(want, pipe.decode_block(x))
    _check(want, pipe.decode_block(np.stack([x.real, x.imag], -1).astype(
        np.float32)))
    pipe.reset_voice_state([0])
    got = pipe.decode_block(torch.from_numpy(x))
    assert got.shape == (3, 8000)
    row = got[0].astype(np.float64)
    spec = np.abs(np.fft.rfft(row * np.hanning(row.size)))
    f = np.fft.rfftfreq(row.size, 1 / 8000.0)
    assert abs(f[np.argmax(spec[5:]) + 5] - 1000.0) < 10.0


def test_pipeline_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        P.BatchedAnalogVoicePipeline(1)
