"""The GF(64) Reed-Solomon pieces of the PyTorch port against the JAX
package: kernel K7's plain version (``fec.device.rs_syndromes_batch``
on the CPU), K7's host table through the kernel's GF(2) product
written in torch, and the host RS(63,35) decoder (``fec.rs``),
bit for bit; K7 itself against its plain version on the card.

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


def _k7_syndromes(words: torch.Tensor, table: np.ndarray, nroots: int):
    """K7's arithmetic on the CPU: each word's 12 bit dwords (dword
    M = 2b + h holds bit b of symbols 32h .. 32h + 31, as the kernel's
    ballots make them), H read out of ``table`` the way the kernel's
    lanes hold it (lane 4g + t of n-tile (q, o): dwords 8s + t and
    8s + 4 + t of column 8q + g), and the mma's AND-popcount over all 512
    bits of K, whose low bit is the syndrome bit (int64 products of 0/1
    bits, summed)."""
    N, n = words.shape
    sym = torch.zeros((N, 64), dtype=torch.long)
    sym[:, :n] = words.long()
    t = torch.arange(32)
    a_bits = torch.zeros((N, 16, 32), dtype=torch.long)    # [word, M, t]
    for m in range(12):
        a_bits[:, m] = (sym[:, 32 * (m % 2) + t] >> (m // 2)) & 1
    tab = torch.as_tensor(table.astype(np.int64))
    G = tab.shape[0]
    h_bits = torch.zeros((16, 32, 8 * G, 6), dtype=torch.long)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for s in range(2):
            for reg in range(2):
                m = 8 * s + 4 * reg + t4
                h_bits[m, :, g::8, :] = (tab[:, :, s, lane, reg, None]
                                         >> t).permute(2, 0, 1) & 1
    count = torch.einsum("nmt,mtio->nio", a_bits, h_bits)
    six = torch.arange(6)
    return ((count & 1) << six).sum(dim=-1)[:, :nroots].to(torch.int32)


@pytest.mark.parametrize("n,nroots,fcr", [(63, 28, 1), (50, 12, 1),
                                          (50, 40, 0), (24, 16, 0)])
def test_k7_table_gf2_product_matches_jax(n, nroots, fcr):
    """K7's table (``fec.device.k7_table``, the matrix H in the order the
    kernel's lanes read it) gives the JAX function's syndromes through
    the kernel's bit dwords and AND-popcount product: on random words,
    clean codewords of the (n, n - nroots) code, and those codewords
    with 1-6 symbols changed (all flagged)."""
    from dsdneo_tpu.fec.device import rs_syndromes_batch
    rng = np.random.default_rng(1000 + n + nroots)
    code = trs.ReedSolomon(n, n - nroots, fcr)
    clean = np.stack([code.encode(rng.integers(0, 64, n - nroots))
                      for _ in range(20)])
    bad = clean.copy()
    for r in range(len(bad)):
        pos = rng.choice(n, int(rng.integers(1, 7)), replace=False)
        bad[r, pos] ^= rng.integers(1, 64, pos.size)
    w = np.concatenate([rng.integers(0, 64, (37, n)), clean, bad]
                       ).astype(np.int32)
    want = rs_syndromes_batch(w, nroots=nroots, fcr=fcr)
    table = fdev.k7_table(n, nroots, fcr)
    assert table.shape == (-(-nroots // 8), 6, 2, 32, 2)
    got = _k7_syndromes(torch.as_tensor(w), table, nroots)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[37:57].any() and got[57:].any(dim=1).all()


def test_k7_table_is_the_field_product():
    """Column (i, o) of K7's H, at row (b, j), is bit o of the field's
    product α^b · β_i^(n-1-j) = exp[(b + (n-1-j)(fcr+i)) mod 63] computed
    by repeated multiplication with the field's log table, for RS(63,35);
    rows past n and the padded roots are zero (n = 50, 12 roots)."""
    exp_t, log_t = trs.gf64_tables()

    def mul(x, y):
        return 0 if not x or not y else int(exp_t[(log_t[x] + log_t[y])
                                                  % 63])

    def h_of(table):
        """H [b, j, i, o] read back out of the table."""
        G = table.shape[0]
        h = np.zeros((6, 64, 8 * G, 6), np.int64)
        for lane in range(32):
            g, t4 = lane >> 2, lane & 3
            for s in range(2):
                for reg in range(2):
                    m = 8 * s + 4 * reg + t4
                    if m >= 12:
                        assert not table[:, :, s, lane, reg].any()
                        continue
                    d = table[:, :, s, lane, reg].astype(np.int64)
                    for t in range(32):
                        h[m // 2, 32 * (m % 2) + t, g::8] = (d >> t) & 1
        return h

    h = h_of(fdev.k7_table(63, 28, 1))
    for i in range(28):
        beta = int(exp_t[(1 + i) % 63])
        p = 1                                   # β^(n-1-j) for j = 62
        for j in range(62, -1, -1):
            for b in range(6):
                v = mul(1 << b, p)
                np.testing.assert_array_equal(h[b, j, i],
                                              (v >> np.arange(6)) & 1)
            p = mul(p, beta)
    h = h_of(fdev.k7_table(50, 12, 1))
    assert not h[:, 50:].any() and not h[:, :, 12:].any()
    assert h[:, :50, :12].any(axis=(0, 2, 3)).all()


@pytest.mark.parametrize("bad", [64, -1])
def test_rs_syndromes_host_words_range_checked_on_the_host(bad):
    """Host words (numpy) are checked before anything touches a device:
    with no device given they would go to the card, which this test
    never reaches (on a machine without one that would raise
    RuntimeError, not ValueError)."""
    w = np.zeros((3, 63), np.int64)
    w[2, 40] = bad
    with pytest.raises(ValueError, match="RS-63 family only|negative"):
        fdev.rs_syndromes_batch(w, 28, 1)
    with pytest.raises(ValueError, match="RS-63 family only|negative"):
        fdev.rs_syndromes_batch(torch.as_tensor(w), 28, 1, device="cuda")


def test_rs_syndromes_host_words_to_the_cpu_match_jax():
    from dsdneo_tpu.fec.device import rs_syndromes_batch
    w = _words(seed=3).astype(np.int64)
    before = fdev.rs_syndromes_batch.launches
    got = fdev.rs_syndromes_batch(w, 28, 1, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  rs_syndromes_batch(w, nroots=28, fcr=1))
    assert fdev.rs_syndromes_batch.launches == before


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
    """K7 on the card against its plain version, bit for bit: random
    words and clean codewords at every word count that leaves a partial
    or empty block of 32 and at the ESS path's and the synthetic sizes,
    each word length and root count, each with fcr 0 and fcr 1 (40
    roots take a second round past the first 32)."""
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
    rng = np.random.default_rng(10)
    big = torch.as_tensor(rng.integers(0, 64, (20480, 63)).astype(np.int32),
                          device="cuda")
    big[rng.random(big.shape) < 0.3] = 0
    for N in (0, 1, 31, 32, 33, 2560, 20480):
        for n in (1, 24, 50, 63):
            for nroots in (12, 28, 40):
                for fcr in (0, 1):
                    words = big[:N, :n]
                    got = fdev.rs_syndromes_batch(words, nroots, fcr)
                    want = fdev.rs_syndromes_plain(words, nroots, fcr)
                    assert (got.shape == (N, nroots)
                            and torch.equal(got, want)), (N, n, nroots, fcr)


@pytest.mark.cuda
def test_rs_syndromes_kernel_views_int64_and_host_words_on_card():
    """K7 on int64 words, on a view 4 bytes off alignment, on a strided
    view, and on numpy words sent to the card (range checked on the
    host); every call one launch, all equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = torch.as_tensor(_words(n_random=2001, n_clean=40, seed=11),
                        device="cuda")
    want = fdev.rs_syndromes_plain(w, 28, 1)
    flat = torch.zeros(w.numel() + 1, dtype=torch.int32, device="cuda")
    flat[1:] = w.reshape(-1)
    off = flat[1:].view(w.shape)                   # 4 bytes past 16
    wide = torch.zeros((w.shape[0], 70), dtype=torch.int32, device="cuda")
    wide[:, 3:66] = w
    before = fdev.rs_syndromes_batch.launches
    for words in (w.long(), off, wide[:, 3:66], w.cpu().numpy()):
        got = fdev.rs_syndromes_batch(words, 28, 1, device="cuda")
        assert torch.equal(got, want)
    for n, nroots, fcr in ((50, 40, 0), (24, 12, 0), (50, 40, 1),
                           (24, 12, 1)):
        torch.testing.assert_close(
            fdev.rs_syndromes_batch(off[:, :n], nroots, fcr),
            fdev.rs_syndromes_plain(w[:, :n], nroots, fcr), rtol=0, atol=0)
    assert fdev.rs_syndromes_batch.launches == before + 8
