"""The Viterbi decoders of the PyTorch port against the JAX package.

K4's plain version (``fec.device.p25_12_decode_plain``) against the JAX
``p25_12_decode_batch`` on hard bits and on int32 LLRs (the cases of
``tests/test_fec_device.py``), bits and path costs; K5's plain version
(``conv_k5_decode_plain``) against the JAX ``conv_k5_decode_batch`` on
punctured symbols with flipped bits (``tests/test_ccbatch.py``) and on
soft symbols with soft weights and on a stride-0 view of one weight row;
K4's entry point on CPU bits against the JAX function on bits; the
wrappers' input forms (``_k4_input``, ``_k5_inputs``: the kernels'
dtypes, a broadcast weight row kept as one row, copies only of what is
misaligned or strided); the port's host copies
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


def test_k4_entry_point_on_cpu_matches_jax_on_bits():
    _rng, _data, words = _noisy_words(64, seed=9, max_flips=10)
    want_b, want_c = jdev.p25_12_decode_batch(jnp.asarray(words))
    got_b, got_c = device.p25_12_decode_batch(torch.as_tensor(words))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("steps", [175, 148])
def test_k5_plain_on_a_broadcast_weight_row_matches_jax(steps):
    """The NXDN and M17 paths pass one weight row as a stride-0 view; the
    plain version on that view equals the JAX function on the broadcast
    array."""
    rng = np.random.default_rng(steps)
    sym = np.stack([jconv.encode(rng.integers(0, 2, steps - 4)
                                 .astype(np.uint8)) for _ in range(24)]
                   ).astype(np.float32)
    flip = rng.random(sym.shape) < 0.02
    sym[flip] = 1.0 - sym[flip]
    row = (rng.random(2 * steps) >= 1 / 7).astype(np.float32)
    for s in (sym, np.clip(sym + rng.normal(0, 0.3, sym.shape), 0, 1
                           ).astype(np.float32)):
        view = torch.as_tensor(row).expand(24, -1)
        assert view.stride() == (0, 1)
        want = jdev.conv_k5_decode_batch(
            jnp.asarray(s), jnp.asarray(np.broadcast_to(row, s.shape)))
        got = device.conv_k5_decode_batch(torch.as_tensor(s), view)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [0, 1, 2, 33])
def test_k5_inputs_keep_one_weight_row(n):
    """``_k5_inputs``: a stride-0 weight view of two or more words stays
    one row (stride 0), moved only when off the kernel's 8-byte pairs;
    other layouts (and a view of at most one word, which PyTorch gives
    its row's stride) go in contiguous (stride 2n); aligned contiguous
    symbols are not copied."""
    sym = torch.rand(n, 20)
    row = torch.rand(20)
    buf = torch.rand(21)
    for r in (row, buf[1:]):
        s, w, stride = device._k5_inputs(sym, r.expand(n, -1))
        assert s.data_ptr() == sym.data_ptr() and w.data_ptr() % 8 == 0
        if n > 1:
            assert stride == 0 and w.shape == (20,) and torch.equal(w, r)
            assert (w.data_ptr() == r.data_ptr()) == (r is row)
        else:
            assert stride == 20 and torch.equal(w, r.expand(n, -1))
    full = torch.rand(n, 20)
    s, w, stride = device._k5_inputs(sym, full)
    assert stride == 20 and w.data_ptr() == full.data_ptr()
    s, w, stride = device._k5_inputs(sym.t().contiguous().t(),
                                     full.t().contiguous().t())
    assert stride == 20 and w.is_contiguous() and s.is_contiguous()
    assert torch.equal(w, full) and torch.equal(s, sym)
    sbuf = torch.rand(n * 20 + 1)
    s, _w, _stride = device._k5_inputs(sbuf[1:].view(n, 20), full)
    assert s.data_ptr() % 8 == 0 and torch.equal(s, sbuf[1:].view(n, 20))


@pytest.mark.parametrize("n", [0, 1, 33])
def test_k4_input_forms(n):
    """``_k4_input``: bits go in as uint8 (bool viewed as uint8, not
    copied), LLRs as they are; 16-byte aligned and contiguous, copied
    only when not."""
    words = _noisy_words(max(n, 1), seed=n, max_flips=3)[2][:n]
    bt = torch.as_tensor(words)
    x, hard = device._k4_input(bt, None)
    assert hard and x.data_ptr() == bt.data_ptr()
    flags = bt.bool()
    x, hard = device._k4_input(flags, None)
    assert hard and x.dtype == torch.uint8 and torch.equal(x, bt)
    assert x.data_ptr() == flags.data_ptr()
    buf = torch.zeros(n * 196 + 1, dtype=torch.uint8)
    buf[1:] = bt.reshape(-1)
    x, hard = device._k4_input(buf[1:].view(n, 196), None)
    assert hard and x.data_ptr() % 16 == 0 and torch.equal(x, bt)
    llr = device._hard_llr(bt)
    x, hard = device._k4_input(bt, llr)
    assert not hard and x.data_ptr() == llr.data_ptr()
    x, hard = device._k4_input(bt, llr.t().contiguous().t())
    assert not hard and x.is_contiguous() and torch.equal(x, llr)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__c652fb32_10_conv_k3_cu_6eee3c6314conv_k3_kernelEPKhPhii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__c652fb32_10_conv_k3_cu_6eee3c6314conv_k3_kernelEPKhPhii
    272 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 272 bytes cumulative stack size
ptxas info    : Compile time = 26.704 ms
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__5a93a9b9_14_p25_trellis_cu_31af8e1518p25_trellis_kernelILb0EEEvPKhPhPii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__5a93a9b9_14_p25_trellis_cu_31af8e1518p25_trellis_kernelILb0EEEvPKhPhPii
    40 bytes stack frame, 36 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 40 bytes cumulative stack size, 25088 bytes smem
"""


def test_ptxas_report_reads_each_kernels_resources():
    """``kernels.ptxas_report`` (which ``chip_smoke.py`` holds K4 and K5
    to: no stack, no spills) on the form ``nvcc -Xptxas -v`` prints;
    a non-entry function's properties are not an entry's."""
    from dsdneo_tpu_torch import kernels
    rep = kernels.ptxas_report(PTXAS_LOG)
    assert sorted(rep) == sorted(k for k in re.findall(
        r"entry function '([^']+)'", PTXAS_LOG))
    k3, k4 = (next(v for k, v in rep.items() if name in k)
              for name in ("conv_k3_kernel", "p25_trellis_kernel"))
    assert k3 == {"stack": 272, "spill_stores": 0, "spill_loads": 0,
                  "registers": 30}
    assert k4 == {"stack": 40, "spill_stores": 36, "spill_loads": 36,
                  "registers": 255}
    assert kernels.ptxas_report("") == {}


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


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_kernel_sources_hold_the_host_tables():
    """The constant tables of ``csrc/p25_trellis.cu`` (and of the
    lanes-per-word designs in ``csrc/alt/viterbi_lanes.cu``) are the
    deinterleave map and transition table of the JAX package's lattice;
    ``csrc/conv_k5.cu``'s output formula (and the alternative's) gives
    ``fec.conv``'s tables."""
    deperm, expect, _nib = jdev._p25_trellis_consts()
    k4, k5, alt = (_source(name) for name in
                   ("p25_trellis.cu", "conv_k5.cu",
                    os.path.join("alt", "viterbi_lanes.cu")))
    for src in (k4, alt):
        np.testing.assert_array_equal(_c_array(src, "c_deperm"), deperm)
        np.testing.assert_array_equal(_c_array(src, "c_dtm"),
                                      jtrellis.P25_DTM)
        assert "deperm4((r + 1) % 4) + 4 * (q + (r + 1) / 4)" in src
    np.testing.assert_array_equal(device.p25_trellis_consts()[1], expect)
    # step i's four LLRs are consecutive from a multiple of 4, and step
    # 4q + r starts 4q past step r (the kernel's groups of four steps)
    d = deperm.reshape(49, 4)
    assert ((d - d[:, :1]) == np.arange(4)).all() and (d[:, 0] % 4 == 0).all()
    i = np.arange(49)
    np.testing.assert_array_equal(d[:, 0], d[i % 4, 0] + 4 * (i // 4))
    assert "deperm4(i % 4) + 4 * (i / 4)" in k4
    for src in (k5, alt):
        assert "(b ^ s2 ^ s3) | ((b ^ s0 ^ s1 ^ s3) << 1)" in src
    for p in range(16):
        s0, s1, s2, s3 = (p & 1, (p >> 1) & 1, (p >> 2) & 1, (p >> 3) & 1)
        for b in range(2):
            assert jconv._O1[p, b] == b ^ s2 ^ s3
            assert jconv._O2[p, b] == b ^ s0 ^ s1 ^ s3


@pytest.mark.parametrize("steps", [1, 5, 175])
def test_encode_rows_is_encode_on_every_row(steps):
    """``fec.conv.encode_rows`` (the card tests' and ``chip_smoke.py``'s
    K5 inputs) on rows that end in 4 zero flush bits is the JAX
    ``encode`` of each row's data, row by row."""
    rng = np.random.default_rng(steps)
    data = rng.integers(0, 2, (6, steps))
    sym = conv.encode_rows(np.concatenate(
        [data, np.zeros((6, 4), np.int64)], axis=1))
    assert sym.shape == (6, 2 * (steps + 4)) and sym.dtype == np.float32
    for row, d in zip(sym, data):
        np.testing.assert_array_equal(row, jconv.encode(d))


def test_build_keeps_the_compiler_output_beside_the_library(tmp_path,
                                                            monkeypatch):
    """``kernels._build`` writes the compiler's output beside the library
    and a later process that finds the library built reads it back (the
    resource report ``chip_smoke.py`` holds K4 and K5 to), without
    compiling again; a library with no log beside it reports none."""
    from dsdneo_tpu_torch import kernels
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text("// a source")
    calls = []

    def make(out):
        calls.append(out)
        with open(out, "w") as f:
            f.write("library")
        return PTXAS_LOG

    first = kernels._Lib()
    so = kernels._build(first, "libk", ["-O3"], [str(src)], make)
    assert first.build_log == PTXAS_LOG and len(calls) == 1
    assert open(so + ".log").read() == PTXAS_LOG
    later = kernels._Lib()
    assert kernels._build(later, "libk", ["-O3"], [str(src)], make) == so
    assert later.build_log == PTXAS_LOG and len(calls) == 1
    os.remove(so + ".log")
    again = kernels._Lib()
    kernels._build(again, "libk", ["-O3"], [str(src)], make)
    assert again.build_log == "" and len(calls) == 1
