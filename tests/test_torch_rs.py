"""The GF(64) Reed-Solomon pieces of the PyTorch port against the JAX
package: kernel K7's plain version (``fec.device.rs_syndromes_batch``
on the CPU) and the host RS(63,35) decoder (``fec.rs``), bit for bit;
K7 itself against its plain version on the card.

JAX is imported inside the tests that need it: the card's machine has
none, and runs this file's ``cuda`` test with ``--noconftest``.
"""

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch.fec import device as fdev
from dsdneo_tpu_torch.fec import rs as trs


def _words(n_random=40, n_clean=12, seed=0):
    """Random GF(64) words (a third of their symbols zero) and clean
    RS(63,35) codewords, int32 ``[N, 63]``."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 64, (n_random, 63))
    w[rng.random(w.shape) < 0.3] = 0
    code = trs.rs_63_35()
    cw = np.stack([code.encode(rng.integers(0, 64, 35))
                   for _ in range(n_clean)])
    return np.concatenate([w, cw]).astype(np.int32)


@pytest.mark.parametrize("nroots,fcr", [(28, 1), (12, 1), (16, 0)])
def test_rs_syndromes_plain_matches_jax(nroots, fcr):
    from dsdneo_tpu.fec.device import rs_syndromes_batch
    w = _words(seed=nroots)
    want = rs_syndromes_batch(w, nroots=nroots, fcr=fcr)
    got = fdev.rs_syndromes_batch(torch.as_tensor(w), nroots, fcr)
    assert got.dtype == torch.int32 and got.shape == (len(w), nroots)
    np.testing.assert_array_equal(got.numpy(), want)
    if (nroots, fcr) == (28, 1):
        assert not got[-12:].any() and got[:40].any(dim=1).all()


def test_rs_syndromes_short_words_and_empty():
    from dsdneo_tpu.fec.device import rs_syndromes_batch
    w = _words(seed=5)[:, :24]
    np.testing.assert_array_equal(
        fdev.rs_syndromes_batch(torch.as_tensor(w), 12, 1).numpy(),
        rs_syndromes_batch(w, nroots=12, fcr=1))
    out = fdev.rs_syndromes_batch(torch.zeros((0, 63), dtype=torch.int32),
                                  28)
    assert out.shape == (0, 28)


def test_rs_syndromes_rejects_gf256_symbols():
    w = torch.zeros((2, 12), dtype=torch.int32)
    w[1, 3] = 64
    with pytest.raises(ValueError, match="GF\\(2\\^6\\) RS-63 family only"):
        fdev.rs_syndromes_batch(w, 3, 0)


def test_gf64_tables_and_generator_match_jax():
    from dsdneo_tpu.fec.rs import rs_24_12_13, rs_63_35
    f = rs_24_12_13().f
    exp_t, log_t = trs.gf64_tables()
    np.testing.assert_array_equal(exp_t, f.exp_table)
    np.testing.assert_array_equal(log_t, f.log_table)
    assert trs.rs_63_35().genpoly == rs_63_35().genpoly


@pytest.mark.parametrize("n_err", [0, 1, 5, 14, 15, 20])
def test_rs_63_35_decode_matches_jax(n_err):
    """Encode, change ``n_err`` symbols, decode: the corrected word and
    the count (-1 past the code's reach, or a wrong codeword) equal the
    JAX package's."""
    from dsdneo_tpu.fec.rs import rs_63_35
    rng = np.random.default_rng(100 + n_err)
    for _ in range(4):
        cw = trs.rs_63_35().encode(rng.integers(0, 64, 35))
        np.testing.assert_array_equal(cw, rs_63_35().encode(cw[:35]))
        w = cw.copy()
        pos = rng.choice(63, n_err, replace=False)
        w[pos] ^= rng.integers(1, 64, n_err)
        want, n_want = rs_63_35().decode(w, erasures=[])
        got, n_got = trs.rs_63_35().decode(w)
        assert n_got == n_want
        np.testing.assert_array_equal(got, want)
        if n_err <= 14:
            assert n_got == n_err
            np.testing.assert_array_equal(got, cw)


@pytest.mark.cuda
def test_rs_syndromes_kernel_matches_plain_on_card():
    """K7 on the card against its plain version: bit for bit, on random
    words, clean codewords and a batch that leaves a partial block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = torch.as_tensor(_words(n_random=1001, n_clean=30, seed=9))
    want = fdev.rs_syndromes_plain(w, 28, 1)
    before = fdev.rs_syndromes_batch.launches
    got = fdev.rs_syndromes_batch(w.cuda(), 28, 1)
    torch.cuda.synchronize()
    assert fdev.rs_syndromes_batch.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert not got[-30:].any()
    for nroots, fcr in ((12, 1), (40, 0)):
        torch.testing.assert_close(
            fdev.rs_syndromes_batch(w[:, :50].cuda(), nroots, fcr).cpu(),
            fdev.rs_syndromes_plain(w[:, :50], nroots, fcr), rtol=0, atol=0)
