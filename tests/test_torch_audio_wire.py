"""PCM wire formats of the PyTorch port against the JAX package: kernel
K3's plain version (IMA ADPCM encode) bit-identical to
``ops.audio_wire.adpcm_compress``; K3's step model (parallel compares
against packed threshold words, one select tree) equal to IMA's serial
step everywhere; the
port's host decoder, the expanders and µ-law identical."""

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
    np.testing.assert_array_equal(tw.adpcm_expand(blob),
                                  jw.adpcm_expand(blob))
    np.testing.assert_allclose(tw.adpcm_expand(blob),
                               jw.adpcm_expand_np(blob), rtol=2e-7, atol=0)


def _edge_pcm(S, T, seed):
    """Rows that walk the coder to its edges, by row kind: full scale
    +1 and -1; silence; a ±1 square wave at 4 kHz that drives the step
    index to 88, then silence that walks it back to 0; a slow staircase
    over five 16-bit levels (the index stays near 0); speech-like
    tones."""
    rng = np.random.default_rng(seed)
    x = np.zeros((S, T), np.float32)
    t = np.arange(T)
    for s in range(S):
        kind = s % 6
        if kind == 0:
            x[s] = 1.0
        elif kind == 1:
            x[s] = -1.0
        elif kind == 3:
            h = max(T // 2, 1)
            x[s, :h] = np.where(t[:h] % 2 == 0, 1.0, -1.0)
        elif kind == 4:
            x[s] = (t // 40 % 5) * (1.0 / 32767.0)
        elif kind == 5:
            x[s] = _speechlike(1, T, seed + s)[0]
    return x


def _adpcm_np(x, step_table, index_table):
    """Plain NumPy IMA encoder → (codes [S, T], smallest and largest
    step index each row reached)."""
    S, T = x.shape
    xq = np.round(x.astype(np.float32) * np.float32(32767.0)
                  ).astype(np.int64)
    pred = np.zeros(S, np.int64)
    idx = np.zeros(S, np.int64)
    lo, hi = idx.copy(), idx.copy()
    codes = np.zeros((S, T), np.int64)
    for t in range(T):
        step = step_table[idx]
        diff = xq[:, t] - pred
        ad = np.abs(diff)
        b2 = ad >= step
        ad = ad - b2 * step
        b1 = ad >= step >> 1
        ad = ad - b1 * (step >> 1)
        b0 = ad >= step >> 2
        vp = (step >> 3) + b2 * step + b1 * (step >> 1) + b0 * (step >> 2)
        pred = np.clip(pred + np.where(diff < 0, -vp, vp), -32768, 32767)
        code = (diff < 0) * 8 + b2 * 4 + b1 * 2 + b0
        idx = np.clip(idx + index_table[code], 0, 88)
        lo, hi = np.minimum(lo, idx), np.maximum(hi, idx)
        codes[:, t] = code
    return codes, lo, hi


def test_adpcm_edge_rows_match_jax(tables):
    """The edge rows reach step index 88 and come back to 0, and the
    port's plain encoder is bit-identical to the JAX package's there."""
    import jax.numpy as jnp
    from dsdneo_tpu.ops import audio_wire as jw
    from dsdneo_tpu_torch.ops.audio_wire import adpcm_compress
    st, ix = tables.np["adpcm_step"], tables.np["adpcm_index"]
    pcm = _edge_pcm(6, 1600, 7)
    codes, lo, hi = _adpcm_np(pcm, st, ix)
    assert hi[3] == 88 and lo[3] == 0 and hi[4] <= 8
    want = np.asarray(jw.adpcm_compress(jnp.asarray(pcm)))
    np.testing.assert_array_equal(want, codes[:, 0::2] | codes[:, 1::2] << 4)
    got = adpcm_compress(torch.from_numpy(pcm), tables.adpcm_step,
                         tables.adpcm_index)
    np.testing.assert_array_equal(got.numpy(), want)


def test_adpcm_kernel_step_model_exhaustive(tables):
    """K3's step (csrc/adpcm_enc.cu encode_fast) against IMA's serial
    subtract chain, for every step index (89) and every |diff| the
    kernel can see (0..131070, its input being clamped to +-98302): the
    magnitude from seven parallel compares of |diff| << 15 | 0x7FFF
    against the packed words W_k = T_k << 15 | next_k, and the word the
    kernel's select tree (pick8) picks: its T_m gives vpdiff, its low
    bits m and the next row, all equal."""
    st = tables.np["adpcm_step"].astype(np.int64)
    itab = tables.np["adpcm_index"].astype(np.int64)
    np.testing.assert_array_equal(itab[:8], itab[8:])
    assert st.max() <= 0x7FFF
    # the kernel's rows: W[idx][k] = T_k << 15 | (next row * 32 + k)
    k = np.arange(8)
    ni = np.clip(np.arange(89)[:, None] + itab[None, :8], 0, 88)
    thr = (((k & 4) > 0) * st[:, None] + ((k & 2) > 0) * (st[:, None] >> 1)
           + ((k & 1) > 0) * (st[:, None] >> 2))
    W = (thr << 15) | (ni * 32 + k)
    assert W.max() < 2 ** 32 and (ni * 32 + k).max() < 2 ** 15

    def pick8(c, v):                  # the kernel's select tree
        c1, c2, c3, c4, c5, c6, c7 = c
        p01, p23 = np.where(c1, v[1], v[0]), np.where(c3, v[3], v[2])
        p45, p67 = np.where(c5, v[5], v[4]), np.where(c7, v[7], v[6])
        return np.where(c4, np.where(c6, p67, p45), np.where(c2, p23, p01))

    ad = np.arange(2 * 65535 + 1, dtype=np.int64)
    adk = (ad << 15) | 0x7FFF
    assert adk.max() < 2 ** 32
    for idx in range(89):
        step = st[idx]
        # IMA's serial chain
        r = ad.copy()
        b2 = r >= step
        r = r - b2 * step
        b1 = r >= step >> 1
        r = r - b1 * (step >> 1)
        b0 = r >= step >> 2
        m = 4 * b2 + 2 * b1 + b0
        vp = (step >> 3) + b2 * step + b1 * (step >> 1) + b0 * (step >> 2)
        nidx = np.clip(idx + itab[m], 0, 88)
        # the kernel's parallel form
        assert list(thr[idx]) == sorted(thr[idx])
        w = pick8([adk >= W[idx, j] for j in range(1, 8)], list(W[idx]))
        np.testing.assert_array_equal(w & 7, m, err_msg=f"idx {idx}")
        np.testing.assert_array_equal((W[idx, 4] >> 18) + (w >> 15), vp,
                                      err_msg=f"idx {idx}")
        np.testing.assert_array_equal((w & 0x7FF0) // 32, nidx,
                                      err_msg=f"idx {idx}")


def test_host_decoder_equals_plain(tables):
    """The port's C++ decoder (csrc/adpcm_dec.cpp) against the plain
    NumPy decoder on random blobs: the same 16-bit levels, scaled by the
    float32 product with 1/32767 where the plain one divides (at most
    one float32 ulp apart)."""
    from dsdneo_tpu_torch.ops import audio_wire as tw
    st, ix = tables.np["adpcm_step"], tables.np["adpcm_index"]
    for seed, shape in ((5, (3, 1)), (6, (7, 513)), (7, (40, 2000))):
        blob = np.random.default_rng(seed).integers(0, 256, shape
                                                    ).astype(np.uint8)
        got = tw.adpcm_expand(blob)
        want = tw.adpcm_expand_np(blob, st, ix)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(np.rint(got * 32767.0),
                                      np.rint(want * 32767.0))
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def test_adpcm_compress_takes_only_ima_tables(tables):
    """The encoder raises on tables other than IMA's, which K3's packed
    rows and the host decoder assume, and accepts IMA's again after."""
    from dsdneo_tpu_torch.ops.audio_wire import adpcm_compress
    pcm = torch.from_numpy(_speechlike(2, 64, 9))
    st, ix = tables.adpcm_step.clone(), tables.adpcm_index.clone()
    assert adpcm_compress(pcm, st, ix).shape == (2, 32)
    st[5] += 1                             # in place: checked again
    with pytest.raises(ValueError, match="IMA"):
        adpcm_compress(pcm, st, ix)
    ix2 = ix.clone()
    ix2[12] = 3
    with pytest.raises(ValueError, match="IMA"):
        adpcm_compress(pcm, tables.adpcm_step, ix2)


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
        out = wire_expand(w.numpy(), fmt, 2)
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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2, 160, 962, 25920])
def test_k3_kernel_edges_on_card(tables, T):
    """K3 bit-identical to its plain version (run on the CPU) for
    S in {1, 31, 33, 320} streams of the edge rows: ±1, silence, the
    square wave that drives the index to 88 and back to 0, the slow
    staircase that keeps it near 0, speech-like tones; rows of a length
    that is not a multiple of 8, and a view that starts off a 16-byte
    boundary, go through the wrapper's zero tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch.ops.audio_wire import (adpcm_compress,
                                                 adpcm_compress_plain)
    pcm = torch.from_numpy(_edge_pcm(320, T, 8))
    want = adpcm_compress_plain(pcm, tables.adpcm_step, tables.adpcm_index)
    st, ix = tables.adpcm_step.cuda(), tables.adpcm_index.cuda()
    for S in (1, 31, 33, 320):
        got = adpcm_compress(pcm[:S].cuda(), st, ix)
        torch.cuda.synchronize()
        assert got.shape == (S, T // 2)
        assert torch.equal(got.cpu(), want[:S]), f"S={S} T={T}"
    flat = torch.zeros(33 * T + 1, device="cuda")
    off = flat[1:].view(33, T)                # 4 bytes past the boundary
    off.copy_(pcm[:33].cuda())
    assert torch.equal(adpcm_compress(off, st, ix).cpu(), want[:33])


@pytest.mark.cuda
@pytest.mark.parametrize("n_sf", [1, 3, 15, 16])
def test_k3_kernel_at_dmr_lengths_on_card(tables, n_sf):
    """K3 at the DMR path's row lengths: ``n_sf`` superframes of 18
    frames, the step count padded to a multiple of 36 as the pipeline
    pads it, 160 samples a frame (up to 46,080 samples); 7 streams,
    bit-identical to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch.ops.audio_wire import (adpcm_compress,
                                                 adpcm_compress_plain)
    T = -(-n_sf * 18 // 36) * 36 * 160
    pcm = torch.from_numpy(_speechlike(7, T, n_sf))
    want = adpcm_compress_plain(pcm, tables.adpcm_step, tables.adpcm_index)
    got = adpcm_compress(pcm.cuda(), tables.adpcm_step.cuda(),
                         tables.adpcm_index.cuda())
    torch.cuda.synchronize()
    assert got.shape == (7, T // 2)
    assert torch.equal(got.cpu(), want)
