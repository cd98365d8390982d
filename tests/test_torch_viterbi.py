"""The Viterbi decoders of the PyTorch port against the JAX package.

K4's plain version (``fec.device.p25_12_decode_plain``) against the JAX
``p25_12_decode_batch`` on hard bits and on int32 LLRs (the cases of
``tests/test_fec_device.py``), bits and path costs; K5's plain version
(``conv_k5_decode_plain``) against the JAX ``conv_k5_decode_batch`` on
punctured symbols with flipped bits (``tests/test_ccbatch.py``) and on
soft symbols with soft weights; the port's host copies
(``fec.trellis.p25_12_decode``, ``p25_12_decode_list``,
``p25_12_encode``, ``fec.conv.encode``, ``decode_soft``,
``fec.crc.crc16_bits``) against their originals; and the constant tables
that the kernels' sources hold against the port's host tables.  All bit
for bit; the JAX functions are jitted, as the JAX pipelines call them.
"""

import os
import re

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")     # the card's machine has none

from dsdneo_tpu.fec import conv as jconv, crc as jcrc, trellis as jtrellis
from dsdneo_tpu.fec import device as jdev
from dsdneo_tpu_torch.fec import conv, crc, device, trellis

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dsdneo_tpu_torch", "csrc")


def _noisy_words(n: int, seed: int, max_flips: int = 4):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (n, 96)).astype(np.uint8)
    words = np.stack([jtrellis.p25_12_encode(d) for d in data])
    for i in range(n):
        k = int(rng.integers(0, max_flips + 1))
        words[i, rng.choice(196, size=k, replace=False)] ^= 1
    return rng, data, words


@pytest.mark.parametrize("soft", [False, True])
def test_k4_plain_matches_jax(soft):
    rng, _data, words = _noisy_words(96, seed=1, max_flips=8)
    llr = None
    if soft:
        llr = (1 - 2 * words.astype(np.int32)) * np.int32(50)
        llr += rng.integers(-20, 20, size=llr.shape).astype(np.int32)
    want_b, want_c = jdev.p25_12_decode_batch(
        jnp.asarray(words), None if llr is None else jnp.asarray(llr))
    got_b, got_c = device.p25_12_decode_plain(
        torch.as_tensor(words), None if llr is None else torch.as_tensor(llr))
    assert got_b.dtype == torch.uint8 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_k4_entry_point_on_cpu_is_the_plain_version():
    _rng, data, words = _noisy_words(8, seed=2, max_flips=0)
    b, c = device.p25_12_decode_batch(torch.as_tensor(words))
    np.testing.assert_array_equal(b.numpy(), data)
    assert (c.numpy() == 0).all()
    assert device.p25_12_decode_batch.launches == 0


@pytest.mark.parametrize("soft", [False, True])
def test_k5_plain_matches_jax(soft):
    rng = np.random.default_rng(5)
    syms, wts = [], []
    for i in range(48):
        enc = jconv.encode(rng.integers(0, 2, 171).astype(np.uint8)
                           ).astype(np.float32)
        wt = np.ones_like(enc)
        wt[rng.choice(enc.size, size=enc.size // 7, replace=False)] = 0.0
        j = rng.choice(enc.size, size=i % 4, replace=False)
        enc[j] = 1.0 - enc[j]
        if soft:
            enc = np.clip(enc + rng.normal(0, 0.35, enc.shape), 0, 1)
            wt = wt * rng.random(enc.shape)
        syms.append(enc.astype(np.float32))
        wts.append(wt.astype(np.float32))
    sym, wt = np.stack(syms), np.stack(wts)
    want = np.asarray(jdev.conv_k5_decode_batch(jnp.asarray(sym),
                                                jnp.asarray(wt)))
    got = device.conv_k5_decode_plain(torch.as_tensor(sym),
                                      torch.as_tensor(wt))
    assert got.dtype == torch.uint8 and got.shape == (48, 175)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the host decoder, which the JAX function is held to
    for i in range(0, 48, 12):
        np.testing.assert_array_equal(
            got.numpy()[i, :171], jconv.decode_soft(sym[i], wt[i], nbits=171))


def test_host_trellis_copy_matches_original():
    rng, data, words = _noisy_words(12, seed=3, max_flips=10)
    for d in data[:4]:
        np.testing.assert_array_equal(trellis.p25_12_encode(d),
                                      jtrellis.p25_12_encode(d))
    np.testing.assert_array_equal(trellis.interleave_98(),
                                  jtrellis.interleave_98())
    np.testing.assert_array_equal(trellis.P25_DTM, jtrellis.P25_DTM)
    for w in words:
        llr = ((1 - 2 * w.astype(np.int32))
               * rng.integers(1, 100, 196)).astype(np.int32)
        for args in ((w,), (w, llr)):
            a, ca = trellis.p25_12_decode(*args)
            b, cb = jtrellis.p25_12_decode(*args)
            np.testing.assert_array_equal(a, b)
            assert ca == cb
        for depth in (1, 3, 8):
            got = trellis.p25_12_decode_list(w, llr, max_candidates=depth)
            want = jtrellis.p25_12_decode_list(w, llr, max_candidates=depth)
            assert len(got) == len(want) > 0
            for (ga, gm), (wa, wm) in zip(got, want):
                np.testing.assert_array_equal(ga, wa)
                assert gm == wm


def test_host_conv_and_crc_copies_match_originals():
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(conv._O1, jconv._O1)
    np.testing.assert_array_equal(conv._O2, jconv._O2)
    for n in (26, 80, 171):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        enc = conv.encode(bits)
        np.testing.assert_array_equal(enc, jconv.encode(bits))
        noisy = enc.astype(np.float32)
        noisy[rng.choice(enc.size, 3, replace=False)] = 0.5
        wt = rng.random(enc.size).astype(np.float32)
        np.testing.assert_array_equal(conv.decode_soft(noisy, wt),
                                      jconv.decode_soft(noisy, wt))
        assert (crc.crc16_bits(bits, init=0, xorout=0xFFFF)
                == jcrc.crc16_bits(bits, init=0, xorout=0xFFFF))


def _c_array(src: str, name: str) -> np.ndarray:
    body = re.search(name + r"\[[^\]]*\]\s*=\s*\{([^}]*)\}", src).group(1)
    return np.array([int(v) for v in body.replace("\n", " ").split(",")
                     if v.strip()])


def test_kernel_sources_hold_the_host_tables():
    """The __constant__ tables of ``csrc/p25_trellis.cu`` are the
    deinterleave map and transition table of the JAX package's lattice;
    ``csrc/conv_k5.cu``'s output formula gives ``fec.conv``'s tables."""
    with open(os.path.join(CSRC, "p25_trellis.cu")) as f:
        src = f.read()
    deperm, expect, _nib = jdev._p25_trellis_consts()
    np.testing.assert_array_equal(_c_array(src, "c_deperm"), deperm)
    np.testing.assert_array_equal(_c_array(src, "c_dtm"),
                                  jtrellis.P25_DTM)
    np.testing.assert_array_equal(device.p25_trellis_consts()[1], expect)
    # step i's four LLRs are consecutive from a multiple of 4
    d = deperm.reshape(49, 4)
    assert ((d - d[:, :1]) == np.arange(4)).all() and (d[:, 0] % 4 == 0).all()
    with open(os.path.join(CSRC, "conv_k5.cu")) as f:
        src = f.read()
    assert "(b ^ s2 ^ s3) | ((b ^ s0 ^ s1 ^ s3) << 1)" in src
    for p in range(16):
        s0, s1, s2, s3 = (p & 1, (p >> 1) & 1, (p >> 2) & 1, (p >> 3) & 1)
        for b in range(2):
            assert jconv._O1[p, b] == b ^ s2 ^ s3
            assert jconv._O2[p, b] == b ^ s0 ^ s1 ^ s3
