"""The AMBE+2 core of the PyTorch port against the JAX package: the
voice-frame ECC, the parameter decode, the tone and error gate, and the
scatter / frame-repeat / synthesis / wire tail that every AMBE family
shares.  Inputs are seeded numpy arrays; the JAX functions run inside
``jax.jit``, as ``dmr_voice_decode_gather`` runs them.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")     # the card's machine has none
import jax.numpy as jnp

from dsdneo_tpu.fec import device as jfec
from dsdneo_tpu.ops import audio_wire as jwire
from dsdneo_tpu.protocol.dmr.ambe_frame import encode_ambe_ecc
from dsdneo_tpu.vocoder import device as jvoc
from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.fec import device as tfec
from dsdneo_tpu_torch.ops import audio_wire as twire
from dsdneo_tpu_torch.vocoder import device as tvoc

T = torch.as_tensor


@pytest.fixture(scope="module")
def tables():
    return params.load_dmr("cpu")


def _field(bits, lo, n, value):
    bits[:, lo:lo + n] = (np.asarray(value)[:, None]
                          >> np.arange(n - 1, -1, -1)) & 1


def _tone_frames(bits, rows, ids, ads, broken=()):
    """Make ``rows`` tone frames (pitch code 0x7F, the ID twice); rows in
    ``broken`` get a second ID that differs, so they are no tone."""
    sub = bits[rows]
    _field(sub, 0, 7, np.full(len(rows), 0x7F))
    _field(sub, 7, 7, ids)
    _field(sub, 14, 7, ads)
    _field(sub, 21, 7, [i ^ (1 if r in broken else 0)
                        for r, i in zip(rows, ids)])
    bits[rows] = sub


# -- ECC -----------------------------------------------------------------------
@pytest.mark.parametrize("n_err", [0, 1, 2, 3, 4, "random_bits"])
def test_ambe_ecc_bit_identical(tables, n_err):
    """Encoded frames with ``n_err`` flipped bits in each Golay word (C0
    with its parity bit, and C1) — up to 3 are corrected, 4 decode to
    another word — and plain random bits: parameter bits and error counts
    identical."""
    rng = np.random.default_rng(17)
    F = 96
    if n_err == "random_bits":
        b72 = rng.integers(0, 2, (F, 72)).astype(np.uint8)
    else:
        b49 = rng.integers(0, 2, (F, 49)).astype(np.uint8)
        b72 = np.stack([encode_ambe_ecc(b) for b in b49])
        gather = tables.np["ambe_gather"]                   # [4, 24]
        for f in range(F):
            for row in (0, 1):
                cols = rng.choice(23, size=n_err, replace=False)
                b72[f, gather[row, cols]] ^= 1
    jb, je = (np.asarray(a) for a in jfec.ambe_ecc_batch(b72))
    tb, te = (a.numpy() for a in tfec.ambe_ecc_batch(T(b72), tables))
    assert tb.dtype == np.uint8 and tb.shape == (F, 49)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(te, je)
    if n_err in (0, 1, 2, 3):
        np.testing.assert_array_equal(tb, b49)
        assert (te == 2 * n_err).all()


def test_ambe_tables_equal_jax_package(tables):
    """``params.dmr_from_numpy`` on arrays taken straight from the JAX
    package gives the tensors the npz gives."""
    gather, g23, pn, par, prm = jfec._ambe_consts()
    W, Cc, A = jvoc._ambe_tables()
    from dsdneo_tpu.fec import blockcodes
    t = dict(tables.np)
    t.update(ambe_gather=gather, golay_codebook=g23.codebook, ambe_pn=pn,
             ambe_parity=par, ambe_param=prm, ambe_w=W, ambe_c=Cc,
             ambe_assigned=A, qr_codebook=blockcodes.qr_16_7_6().codebook,
             adpcm_step=jwire.STEP_TABLE, adpcm_index=jwire.INDEX_TABLE)
    a = params.dmr_from_numpy(t, "cpu")
    for name, v in vars(a).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(tables, name)), name


# -- parameters ------------------------------------------------------------------
def test_ambe_decode_params_every_pitch_and_gain_code(tables):
    """All 128 pitch codes × 64 gain codes (the rest random): L and ω0
    are floors and quotients of a float32 power, so they must be equal to
    the bit; voicing equal; amplitudes within rtol 1e-5 (their ``10**x``
    differs by an ulp between the two libraries)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (128 * 64, 49)).astype(np.uint8)
    _field(bits, 0, 7, np.repeat(np.arange(128), 64))
    _field(bits, 12, 6, np.tile(np.arange(64), 128))
    jw, jL, jv, ja = (np.asarray(a) for a in
                      jax.jit(jvoc.ambe_decode_params)(jnp.asarray(bits)))
    tw, tL, tv, ta = (a.numpy() for a in
                      tvoc.ambe_decode_params(T(bits), tables))
    np.testing.assert_array_equal(tL, jL)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tv, jv)
    assert tL.dtype == np.int32 and tL.min() == 9 and tL.max() == 56
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=0)
    assert ((ta == 0) == (ja == 0)).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_ambe_decode_params_random_bits(tables, seed):
    bits = np.random.default_rng(seed).integers(0, 2, (500, 49)
                                                ).astype(np.uint8)
    want = jax.jit(jvoc.ambe_decode_params)(jnp.asarray(bits))
    got = tvoc.ambe_decode_params(T(bits), tables)
    for name, g, w in zip(("w0", "L", "voiced", "amps"), got, want):
        if name == "amps":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


def _gate_inputs():
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, (64, 49)).astype(np.uint8)
    _tone_frames(bits, [3, 10, 11, 40], [5, 64, 127, 9], [127, 1, 60, 33],
                 broken=(40,))
    errs = rng.integers(0, 7, 64).astype(np.int32)
    errs[[3, 11]] = (0, 5)              # a clean tone and a corrupt one
    return bits, errs


def test_ambe_tone_params_and_frame_mask(tables):
    bits, errs = _gate_inputs()
    ji, jw, ja = (np.asarray(a) for a in jvoc.ambe_tone_params(
        jnp.asarray(bits)))
    ti, tw, ta = (a.numpy() for a in tvoc.ambe_tone_params(T(bits)))
    np.testing.assert_array_equal(ti, ji)
    assert ti[[3, 10, 11]].all() and not ti[40]
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(ta, ja)
    for thr in (3, 0):
        np.testing.assert_array_equal(
            tvoc.ambe_frame_mask(T(bits), T(errs), thr).numpy(),
            np.asarray(jvoc.ambe_frame_mask(jnp.asarray(bits),
                                            jnp.asarray(errs), thr)))


@pytest.mark.parametrize("thr", [3, 1])
def test_ambe_params_gated_with_tone_frames(tables, thr):
    bits, errs = _gate_inputs()
    want = jax.jit(functools.partial(jvoc.ambe_params_gated, thr=thr))(
        jnp.asarray(bits), jnp.asarray(errs))
    got = tvoc.ambe_params_gated(T(bits), T(errs), tables, thr)
    for name, g, w in zip(("w0", "voiced", "amps", "good"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "amps":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(g, w, name)
    # a tone frame is one harmonic of half the tone amplitude
    assert got[1][3, 0] == 1 and got[1][3, 1:].sum() == 0
    assert float(got[2][3, 0]) == pytest.approx(127 * 75.0 / 8000.0 / 2)


# -- the tail --------------------------------------------------------------------
def _tail_inputs(tables):
    """Two channels × 36 steps: channel 0 has corrupt runs of 1 to 5
    frames between good ones (the repeat contract covers 3, then mutes),
    channel 1 starts corrupt (it repeats the carried frame) and leaves
    its last steps empty; 10 pad frames go to channel 2 = C, all at step
    0, which is the only place indices repeat."""
    C, n_steps = 2, 36
    rng = np.random.default_rng(23)
    fch = np.concatenate([np.zeros(36), np.ones(24), np.full(10, C)]
                         ).astype(np.int64)
    forder = np.concatenate([np.arange(36), np.arange(24), np.zeros(10)]
                            ).astype(np.int64)
    F = len(fch)
    bits = rng.integers(0, 2, (F, 49)).astype(np.uint8)
    _field(bits, 12, 6, rng.integers(20, 44, F))         # moderate gain
    _tone_frames(bits, [7], [40], [90])
    errs = np.zeros(F, np.int32)
    bad0 = [1, 4, 5, 9, 10, 11, 15, 16, 17, 18, 22, 23, 24, 25, 26]
    errs[bad0] = 4
    errs[36:41] = 6
    real = fch < C
    assert len(set(zip(fch[real], forder[real]))) == real.sum()
    state = ((rng.uniform(0, 6.28, C), rng.uniform(0.05, 0.3, C),
              rng.uniform(0, 0.5, (C, 56))),
             (rng.uniform(0.05, 0.3, C),
              (rng.random((C, 56)) > 0.5).astype(np.float64),
              rng.uniform(0, 0.5, (C, 56)), np.array([0, 2]),
              np.array([1.0, 1.0])))
    state = tuple(tuple(np.asarray(a, np.int32 if a.dtype.kind == "i"
                                   else np.float32) for a in part)
                  for part in state)
    return C, n_steps, bits, errs, fch, forder, state


@pytest.mark.parametrize("fmt", ["f16", "mulaw", "adpcm"])
def test_scatter_repeat_synth_matches(tables, fmt):
    """From a non-zero incoming carry: the new carries equal (theta, the
    repeat counts and flags to the bit; amplitudes rtol 1e-5), and the
    wire PCM within 2e-4 of the peak plus one float16 step for f16; for
    µ-law and ADPCM, whose encoders are bit-exact, at least 99.9% / 99%
    equal bytes (a byte parts only where the PCM, equal to ~1e-6, rounds
    to another level) and expanded PCM within one companding step (0.05
    of the value + 1e-3) / an eighth of the peak."""
    C, n_steps, bits, errs, fch, forder, state = _tail_inputs(tables)
    jparams = jax.jit(jvoc.ambe_params_gated)(jnp.asarray(bits),
                                              jnp.asarray(errs))
    jtail = jax.jit(jvoc.scatter_repeat_synth, static_argnums=(6, 7, 9))
    jw, jstate = jtail(*jparams, jnp.asarray(fch), jnp.asarray(forder), C,
                       n_steps, jax.tree.map(jnp.asarray, state), fmt)
    tparams = tvoc.ambe_params_gated(T(bits), T(errs), tables)
    tstate_in = params.state_from_numpy(None, *state, "cpu")[1:]
    tw, tstate = tvoc.scatter_repeat_synth(
        *tparams, T(fch), T(forder), C, n_steps, tstate_in, fmt, tables)

    (jt, jwl, jal), jrep = jstate
    (tt, twl, tal), trep = tstate
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(twl.numpy(), np.asarray(jwl))
    np.testing.assert_allclose(tal.numpy(), np.asarray(jal), rtol=1e-5)
    for i, (a, b) in enumerate(zip(trep, jrep)):
        if i == 2:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # channel 0 ends on a good frame, channel 1 on empty steps after one
    assert trep[3].tolist() == [0, 0] and trep[4].tolist() == [1.0, 1.0]

    jw, tw = np.asarray(jw), tw.numpy()
    assert tw.shape == jw.shape and tw.dtype == jw.dtype
    jp = jwire.wire_expand(jw, fmt, C)
    tp = twire.wire_expand(tw, fmt, C)
    peak = np.abs(jp).max()
    assert 0.05 < peak <= 1.0 and np.isfinite(tp).all()
    if fmt == "f16":
        np.testing.assert_allclose(tp, jp, atol=2e-4 * peak, rtol=2.0 ** -10)
    elif fmt == "mulaw":
        assert np.mean(tw == jw) >= 0.999
        assert (np.abs(tp - jp) <= 0.05 * np.abs(jp) + 1e-3).all()
    else:
        assert np.mean(tw == jw) >= 0.99
        np.testing.assert_allclose(tp, jp, atol=peak / 8)

    # the repeat contract, on the port's output: a corrupt run is covered
    # for 3 frames, the next frame fades the last amplitudes out, and
    # what follows is silent; so is the empty tail of channel 1
    frames = twire.wire_expand(tvoc.scatter_repeat_synth(
        *tparams, T(fch), T(forder), C, n_steps, tstate_in, "f16",
        tables)[0].numpy(), "f16", C).reshape(C, n_steps, 160)
    loud = np.abs(frames).max(-1) > 0
    assert loud[0, 22:25].all() and not loud[0, 26] and loud[0, 27]
    # channel 1 opens with 5 corrupt frames after a carried good one: as
    # in the JAX package, the count runs from the block's start (the 2
    # repeats the carry says were used are not charged)
    assert loud[1, :3].all() and not loud[1, 4]
    assert loud[1, 5:24].all() and not loud[1, 25:].any()


def test_voice_state_init_and_reset():
    st = tvoc.voice_state_init(3, "cpu")
    jst = jvoc.voice_state_init(3)
    for part, jpart in zip(st, jst):
        assert len(part) == len(jpart)
        for a, b in zip(part, jpart):
            assert tuple(a.shape) == b.shape and not a.any()
            assert str(a.dtype).split(".")[1] == str(b.dtype)
