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


def _pred_case(rng, C, Tn, case):
    """Random K2 inputs with the edge of ``case`` written in."""
    xs = list(_pred_inputs(rng, C, Tn))
    if case == "constant_L":                      # the narrowest and widest
        xs[2][0], xs[2][1] = 9, 56
        xs[3] = np.minimum((xs[2] + 2) // 3, 12).astype(np.int32)
    elif case == "all_inactive":
        xs[5][1] = 0.0
    return xs


@pytest.mark.parametrize("case,steps", [
    ("random", (27, 54)), ("one_step", (1, 1)), ("odd_steps", (31, 31)),
    ("prev_L_zero", (27, 27)), ("all_inactive", (27, 27)),
    ("constant_L", (27, 54))])
def test_prediction_plain_matches_jax_two_blocks(tables, case, steps):
    """K2's plain version over two blocks, the carry passed along."""
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu.vocoder import device as jd
    from dsdneo_tpu_torch.vocoder import device as td
    rng = np.random.default_rng(8)
    C = 3
    prev = (np.zeros((C, 56), np.float32), np.zeros(C, np.int32))
    if case in ("prev_L_zero", "all_inactive"):   # a carry to keep or drop
        prev = (rng.uniform(0, 6, (C, 56)).astype(np.float32),
                np.array([0, 20, 56], np.int32))
    pj = tuple(jnp.asarray(a) for a in prev)
    pt = tuple(_t(a) for a in prev)
    scan = jax.jit(jd._prediction_scan)
    for Tn in steps:
        xs = _pred_case(rng, C, Tn, case)
        want = scan(*(jnp.asarray(a) for a in xs), *pj)
        got = td.prediction_scan(*(_t(a) for a in xs), *pt,
                                 tables.pred_decay, tables.imbe_amp_scale)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)
        pj, pt = want[3:], got[3:]
    if case == "all_inactive":                    # channel 1's carry frozen
        np.testing.assert_array_equal(pt[0][1].numpy(), prev[0][1])
        assert int(pt[1][1]) == prev[1][1]


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


@pytest.mark.parametrize("n", [1, 27, 32, 33, 81, 162, 1100])
def test_tree_sum_in_xla_order(n):
    """``vocoder.synth.tree_sum`` equals XLA's ``jnp.sum`` over the last
    axis under ``jit``/``vmap`` bit for bit (windows of 32 past 32 terms)."""
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu_torch.vocoder.synth import tree_sum
    x = np.random.default_rng(n).uniform(1, 60, (16, n)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.sum))(jnp.asarray(x)))
    np.testing.assert_array_equal(tree_sum(_t(x)).numpy(), want)


@pytest.mark.parametrize("F", [27, 81, 162])
def test_synthesize_stream_theta_carry_exact(tables, F):
    """The theta carry out of a block equals the JAX synthesizer's bit for
    bit, on frames whose ω0 changes every frame (so the interpolation's
    fused multiply-add matters)."""
    import jax
    import jax.numpy as jnp
    from dsdneo_tpu.vocoder import synth as js
    from dsdneo_tpu_torch.vocoder.synth import synthesize_stream
    rng = np.random.default_rng(F)
    C = 8
    args = (rng.uniform(0.05, 0.4, (C, F)), rng.uniform(0, 3, (C, F, 56)),
            (rng.uniform(size=(C, F, 56)) > 0.5),
            rng.uniform(0, 6, (C, F, 56)), rng.uniform(0, 6, C),
            rng.uniform(0.05, 0.4, C), rng.uniform(0, 3, (C, 56)))
    args = [np.asarray(a, np.float32) for a in args]
    args[5][0] = 0.0                              # a fresh stream
    want = jax.jit(jax.vmap(js.synthesize_stream))(
        *(jnp.asarray(a) for a in args))
    got = synthesize_stream(*(_t(a) for a in args), tables=tables)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    peak = np.abs(np.asarray(want[0])).max()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-3 * peak)


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


def _rn32_sum(a, b):
    """float32 round-to-nearest of a + b for float64 a, b, each exact,
    with no double rounding (exact rationals where the float64 sum
    rounds)."""
    from fractions import Fraction
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)            # TwoSum: s + err == a + b
    out = s.astype(np.float32)
    for i in np.flatnonzero(err != 0):
        x = Fraction(float(a.flat[i])) + Fraction(float(b.flat[i]))
        lo = np.float32(float(x))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        out.flat[i] = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                                int(c.view(np.int32)) & 1))
    return out


def test_k2_index_division_matches_ieee():
    """``csrc/imbe_pred.cu`` ``interp`` divides l·p_L by L as r = RN(1/L),
    q0 = RN(n·r), q = RN(q0 + RN(n − q0·L)·r) (two FMAs).  For every l,
    p_L and L in 1..56 that is IEEE division (``__fdiv_rn``) bit for bit;
    float64 holds each product exactly."""
    l = np.arange(1, 57)
    n = np.unique(l[:, None] * l[None, :]).astype(np.float32)[:, None]
    L = l.astype(np.float32)[None, :]
    r = np.float32(1.0) / L
    q0 = n * r
    e = (n.astype(np.float64) - q0.astype(np.float64) * L).astype(np.float32)
    q = _rn32_sum(q0.astype(np.float64),
                  e.astype(np.float64) * r.astype(np.float64))
    np.testing.assert_array_equal(q, n / L)
    assert (q0 != n / L).any()                  # the correction matters


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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch import params
    return params.load("cuda")


def _k2_edge_inputs(C, Tn, seed):
    """K2 inputs with every edge at once: channel 0 at constant L = 9 and
    no previous L, channel 1 at L = 56, the last of C > 2 never active,
    and the first 18 steps inactive everywhere."""
    rng = np.random.default_rng(seed)
    xs = list(_pred_inputs(rng, C, Tn))
    xs[2][0] = 9
    if C > 1:
        xs[2][1] = 56
    xs[3] = np.minimum((xs[2] + 2) // 3, 12).astype(np.int32)
    xs[5][:, :18] = 0.0
    if C > 2:
        xs[5][-1] = 0.0
    prev = (rng.uniform(0, 6, (C, 56)).astype(np.float32),
            rng.integers(0, 57, C).astype(np.int32))
    prev[1][0] = 0
    return [_t(a).cuda() for a in xs], [_t(a).cuda() for a in prev]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 33, 320])
@pytest.mark.parametrize("Tn", [0, 1, 31, 162, 324])
def test_k2_kernel_edges_on_card(C, Tn):
    """Steps off the 32-step chunk, channels off the 4 per block, rows of
    the [C, Tn] inputs off 16-byte boundaries (odd c at Tn = 162), and
    the edges of ``_k2_edge_inputs``."""
    t = _card()
    from dsdneo_tpu_torch.vocoder import device as td
    xs, prev = _k2_edge_inputs(C, Tn, seed=C * 1000 + Tn)
    got = td.prediction_scan(*xs, *prev, t.pred_decay, t.imbe_amp_scale)
    want = td.prediction_scan_plain(*xs, *prev, t.pred_decay,
                                    t.imbe_amp_scale)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    if C > 2:                                   # the inactive channel
        torch.testing.assert_close(got[3][-1], prev[0][-1], rtol=0, atol=0)
        assert int(got[4][-1]) == int(prev[1][-1])


@pytest.mark.cuda
def test_k2_kernel_unaligned_starts_on_card():
    """[C, Tn] inputs that start 4 bytes past a 16-byte boundary are
    taken; T or V off a 16-byte boundary raise."""
    t = _card()
    from dsdneo_tpu_torch.vocoder import device as td
    C, Tn = 5, 97
    xs, prev = _k2_edge_inputs(C, Tn, seed=7)
    for i in (1, 2, 3, 5):                      # w0, L, K, act
        buf = torch.empty(C * Tn + 1, dtype=xs[i].dtype, device="cuda")
        view = buf[1:].view(C, Tn)
        view.copy_(xs[i])
        xs[i] = view
    consts = (t.pred_decay, t.imbe_amp_scale)
    got = td.prediction_scan(*xs, *prev, *consts)
    want = td.prediction_scan_plain(*xs, *prev, *consts)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    for i, shape in ((0, (C, Tn, 56)), (4, (C, Tn, 12))):
        bad = list(xs)
        buf = torch.empty(xs[i].numel() + 1, device="cuda")
        bad[i] = buf[1:].view(shape)
        with pytest.raises(ValueError):
            td.prediction_scan(*bad, *prev, *consts)
