"""PCM wire formats of the PyTorch port against the JAX package: kernel
K3's plain version (IMA ADPCM encode) bit-identical to
``ops.audio_wire.adpcm_compress``; the expanders and µ-law identical."""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def tables():
    from dsdneo_tpu_torch import params
    return params.load("cpu")


def _speechlike(S, T, seed):
    """Harmonic tones with a few clipped peaks and silent stretches."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 8000.0
    f = rng.uniform(100, 1800, (S, 4, 1))
    a = rng.uniform(0.0, 0.5, (S, 4, 1))
    x = (a * np.sin(2 * np.pi * f * t + rng.uniform(0, 6, (S, 4, 1)))
         ).sum(1) + 0.01 * rng.normal(size=(S, T))
    x[:, T // 3:T // 3 + 200] = 0.0
    x[0, :50] = 1.2                                   # beyond full scale
    return np.clip(x, -1.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("S,T,seed", [(3, 1600, 1), (5, 962, 2)])
def test_adpcm_plain_bit_identical(tables, S, T, seed):
    import jax.numpy as jnp
    from dsdneo_tpu.ops import audio_wire as jw
    from dsdneo_tpu_torch.ops.audio_wire import adpcm_compress
    pcm = _speechlike(S, T, seed)
    want = np.asarray(jw.adpcm_compress(jnp.asarray(pcm)))
    got = adpcm_compress(torch.from_numpy(pcm), tables.adpcm_step,
                         tables.adpcm_index)
    assert got.dtype == torch.uint8 and got.shape == (S, T // 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_adpcm_expanders_match(tables):
    from dsdneo_tpu.ops import audio_wire as jw
    from dsdneo_tpu_torch.ops import audio_wire as tw
    blob = np.random.default_rng(4).integers(0, 256, (4, 700)
                                             ).astype(np.uint8)
    st, ix = tables.np["adpcm_step"], tables.np["adpcm_index"]
    np.testing.assert_array_equal(tw.adpcm_expand_np(blob, st, ix),
                                  jw.adpcm_expand_np(blob))
    # the native decoder scales by 1/32767 as a product, so it may sit
    # one float32 ulp from the NumPy decoder; it equals the JAX
    # package's own host expansion exactly
    np.testing.assert_array_equal(tw.adpcm_expand(blob, st, ix),
                                  jw.adpcm_expand(blob))
    np.testing.assert_allclose(tw.adpcm_expand(blob, st, ix),
                               jw.adpcm_expand_np(blob), rtol=2e-7, atol=0)


def test_mulaw_matches(tables):
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu.engine.dmrbatch import mulaw_expand
    from dsdneo_tpu_torch.ops import audio_wire as tw
    p = np.clip(_speechlike(2, 800, 3) * 1.3, -1, 1)

    @jax.jit
    def jax_mulaw(p):          # vocoder.device._decode_from_frames
        y = jnp.sign(p) * jnp.log1p(255.0 * jnp.abs(p)) / np.log1p(255.0)
        return jnp.clip((y + 1.0) * 127.5 + 0.5, 0, 255).astype(jnp.uint8)

    want = np.asarray(jax_mulaw(jnp.asarray(p)))
    got = tw.mulaw_compress(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tw.mulaw_expand(got), mulaw_expand(got))


def test_wire_encode_formats(tables):
    from dsdneo_tpu_torch.ops.audio_wire import wire_encode, wire_expand
    pcm = torch.from_numpy(_speechlike(2, 320, 5)).reshape(2, 2, 160) * 20
    st, ix = tables.np["adpcm_step"], tables.np["adpcm_index"]
    for fmt, dtype, n in (("f16", torch.float16, 320),
                          ("mulaw", torch.uint8, 320),
                          ("adpcm", torch.uint8, 160)):
        w = wire_encode(pcm, fmt, tables.adpcm_step, tables.adpcm_index)
        assert w.dtype == dtype and w.numel() == 2 * n
        out = wire_expand(w.numpy(), fmt, 2, st, ix)
        assert out.shape == (2, 320) and np.isfinite(out).all()
    with pytest.raises(ValueError):
        wire_encode(pcm, "pcm24", tables.adpcm_step, tables.adpcm_index)


@pytest.mark.cuda
def test_k3_kernel_bit_identical_on_card(tables):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch.ops.audio_wire import (adpcm_compress,
                                                 adpcm_compress_plain)
    pcm = torch.from_numpy(_speechlike(64, 3200, 6)).cuda()
    st, ix = tables.adpcm_step.cuda(), tables.adpcm_index.cuda()
    n0 = adpcm_compress.launches
    got = adpcm_compress(pcm, st, ix)
    assert adpcm_compress.launches == n0 + 1
    assert torch.equal(got, adpcm_compress_plain(pcm, st, ix))
