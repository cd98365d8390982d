"""IMBE ECC and the voice decoder of the PyTorch port against the JAX
package: ECC bits and error counts bit-identical; dequantization and the
prediction recurrence (kernel K2's plain version) to f32 rounding (rtol
1e-5; atol 1e-5 where a log-magnitude crosses zero); the repeat gate and
tone fields exact; synthesis within 1e-3 of the peak, across two blocks
with the carry.
"""

import numpy as np
import pytest
import torch

RTOL = 1e-5
ATOL = 1e-5


@pytest.fixture(scope="module")
def tables():
    from dsdneo_tpu_torch import params
    return params.load("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_ecc(frames):
    from dsdneo_tpu.fec.device import imbe_ecc_batch
    b, e = imbe_ecc_batch(frames)
    return np.asarray(b), np.asarray(e)


@pytest.mark.parametrize("kind", ["random", "encoded_with_errors"])
def test_imbe_ecc_bit_identical(tables, kind):
    from dsdneo_tpu_torch.fec.device import imbe_ecc_batch
    rng = np.random.default_rng(17)
    if kind == "random":
        frames = rng.integers(0, 2, size=(96, 144)).astype(np.uint8)
    else:
        from dsdneo_tpu.protocol.p25 import encode
        frames = encode.random_voice_ldus(6, seed=4).reshape(-1, 144).copy()
        for f in range(frames.shape[0]):             # 0..5 flipped bits
            flip = rng.choice(144, size=f % 6, replace=False)
            frames[f, flip] ^= 1
    want_b, want_e = _jax_ecc(frames)
    got_b, got_e = imbe_ecc_batch(_t(frames), tables)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    if kind == "encoded_with_errors":
        assert got_e.numpy().max() > 0


def _bits88(n, seed):
    from dsdneo_tpu.protocol.p25 import encode
    return _jax_ecc(encode.random_voice_ldus(n, seed=seed
                                             ).reshape(-1, 144))[0]


def test_transforms_match(tables):
    import jax.numpy as jnp
    from dsdneo_tpu.vocoder import device as jd
    from dsdneo_tpu_torch.vocoder import device as td
    rng = np.random.default_rng(3)
    # real frames plus random bit strings (every L from 9 to 56)
    bits = np.concatenate([_bits88(2, 1),
                           rng.integers(0, 2, (200, 88)).astype(np.uint8)])
    want = [np.asarray(a) for a in jd._transforms(jnp.asarray(bits))]
    got = [a.numpy() for a in td._transforms(_t(bits), tables)]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def _pred_inputs(rng, C, Tn):
    L = rng.integers(9, 57, size=(C, Tn)).astype(np.int32)
    return (rng.uniform(-2, 8, (C, Tn, 56)).astype(np.float32),
            rng.uniform(0.08, 0.3, (C, Tn)).astype(np.float32), L,
            np.minimum((L + 2) // 3, 12).astype(np.int32),
            (rng.uniform(size=(C, Tn, 12)) > 0.3).astype(np.float32),
            (rng.uniform(size=(C, Tn)) > 0.15).astype(np.float32))


def test_prediction_plain_matches_jax_two_blocks(tables):
    """K2's plain version over two blocks, the carry passed along."""
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu.vocoder import device as jd
    from dsdneo_tpu_torch.vocoder import device as td
    rng = np.random.default_rng(8)
    C = 3
    pj = (jnp.zeros((C, 56)), jnp.zeros(C, jnp.int32))
    pt = (torch.zeros(C, 56), torch.zeros(C, dtype=torch.int32))
    scan = jax.jit(jd._prediction_scan)
    for Tn in (27, 54):
        xs = _pred_inputs(rng, C, Tn)
        want = scan(*(jnp.asarray(a) for a in xs), *pj)
        got = td.prediction_scan(*(_t(a) for a in xs), *pt,
                                 tables.pred_decay, tables.imbe_amp_scale)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)
        pj, pt = want[3:], got[3:]


def test_repeat_gate_matches(tables):
    import jax.numpy as jnp
    from dsdneo_tpu.vocoder import device as jd
    from dsdneo_tpu_torch.vocoder import device as td
    rng = np.random.default_rng(21)
    C, T = 4, 40
    w0 = rng.uniform(0.1, 0.3, (C, T)).astype(np.float32)
    V = (rng.uniform(size=(C, T, 56)) > 0.5).astype(np.float32)
    A = rng.uniform(0, 2, (C, T, 56)).astype(np.float32)
    present = (rng.uniform(size=(C, T)) > 0.2).astype(np.float32)
    good = present * (rng.uniform(size=(C, T)) > 0.4).astype(np.float32)
    state = (rng.uniform(0.1, 0.3, C).astype(np.float32),
             (rng.uniform(size=(C, 56)) > 0.5).astype(np.float32),
             rng.uniform(0, 2, (C, 56)).astype(np.float32),
             np.array([0, 1, 3, 4], np.int32),
             np.array([1, 0, 1, 1], np.float32))
    (w, v, a), st = jd.repeat_gate(*(jnp.asarray(x) for x in
                                     (w0, V, A, good, present)),
                                   tuple(jnp.asarray(s) for s in state))
    (w2, v2, a2), st2 = td.repeat_gate(*(_t(x) for x in
                                         (w0, V, A, good, present)),
                                       tuple(_t(s) for s in state))
    for x, y in zip((w, v, a) + tuple(st), (w2, v2, a2) + tuple(st2)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_tone_and_good_masks_match(tables):
    import jax.numpy as jnp
    from dsdneo_tpu.vocoder import device as jd
    from dsdneo_tpu.vocoder.imbe import B0_HI_POS, B0_LO_POS
    from dsdneo_tpu_torch.vocoder import device as td
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (64, 88)).astype(np.uint8)
    for f in range(0, 64, 2):                   # half the frames: tone codes
        b0 = 208 + f % 12
        for i, p in enumerate(B0_HI_POS):
            bits[f, p] = (b0 >> (7 - i)) & 1
        bits[f, B0_LO_POS[0]] = (b0 >> 1) & 1
        bits[f, B0_LO_POS[1]] = b0 & 1
        if f % 4 == 0:
            bits[f, 19:26] = bits[f, 12:19]
    errs = rng.integers(0, 8, 64).astype(np.int32)
    want = jd.imbe_tone_params(jnp.asarray(bits))
    got = td.imbe_tone_params(_t(bits), tables)
    assert got[0].numpy().sum() > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        td.imbe_frame_good(_t(bits), _t(errs), tables).numpy(),
        np.asarray(jd.imbe_frame_good(jnp.asarray(bits), jnp.asarray(errs))))


def test_synthesize_stream_two_blocks_with_carry(tables):
    """Two blocks of voiced and unvoiced harmonics; block 2 starts from
    the JAX synthesizer's carry, and the port's own carry agrees."""
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu.vocoder import synth as js
    from dsdneo_tpu_torch.vocoder import device as td
    from dsdneo_tpu_torch.vocoder.synth import synthesize_stream
    rng = np.random.default_rng(9)
    C, F = 2, 54
    noise = td.noise_phases(C, F, "cpu").numpy()
    carry_j = (np.zeros(C, np.float32), np.zeros(C, np.float32),
               np.zeros((C, 56), np.float32))
    run = jax.jit(jax.vmap(js.synthesize_stream))
    for blk in range(2):
        w0 = rng.uniform(0.08, 0.25, (C, F)).astype(np.float32)
        w0[:, 10:12] = 0.0                       # a silent gap
        amps = rng.uniform(0, 1, (C, F, 56)).astype(np.float32)
        voiced = (rng.uniform(size=(C, F, 56)) > 0.4).astype(np.float32)
        want = run(*(jnp.asarray(a) for a in (w0, amps, voiced, noise)),
                   *(jnp.asarray(a) for a in carry_j))
        got = synthesize_stream(*(_t(a) for a in (w0, amps, voiced, noise)),
                                *(_t(a) for a in carry_j), tables=tables)
        pj = np.asarray(want[0])
        peak = np.abs(pj).max()
        np.testing.assert_allclose(got[0].numpy(), pj, atol=1e-3 * peak)
        dth = np.angle(np.exp(1j * (got[1].numpy() - np.asarray(want[1]))))
        assert np.abs(dth).max() < 1e-3
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        carry_j = tuple(np.asarray(a) for a in want[1:])


def test_synthesize_one_shot_matches(tables):
    import jax.numpy as jnp
    from dsdneo_tpu.vocoder import synth as js
    from dsdneo_tpu_torch.vocoder.synth import synthesize
    rng = np.random.default_rng(12)
    F = 30
    w0 = rng.uniform(0.1, 0.2, F).astype(np.float32)
    amps = rng.uniform(0, 1, (F, 56)).astype(np.float32)
    voiced = (rng.uniform(size=(F, 56)) > 0.5).astype(np.float32)
    noise = rng.uniform(0, 2 * np.pi, (F, 56)).astype(np.float32)
    want = np.asarray(js.synthesize(*(jnp.asarray(a) for a in
                                      (w0, amps, voiced, noise))))
    got = synthesize(*(_t(a) for a in (w0, amps, voiced, noise)),
                     tables=tables).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.vocoder import device as td
    t = params.load("cuda")
    rng = np.random.default_rng(2)
    xs = [_t(a).cuda() for a in _pred_inputs(rng, 16, 81)]
    prev = (torch.rand(16, 56, device="cuda") * 5,
            torch.randint(0, 57, (16,), dtype=torch.int32, device="cuda"))
    n0 = td.prediction_scan.launches
    got = td.prediction_scan(*xs, *prev, t.pred_decay, t.imbe_amp_scale)
    assert td.prediction_scan.launches == n0 + 1
    want = td.prediction_scan_plain(*xs, *prev, t.pred_decay,
                                    t.imbe_amp_scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
