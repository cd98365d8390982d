"""The D-STAR pipeline of the PyTorch port against the JAX package's
(``engine/dstarbatch.py``), on the CPU.

  - K6's plain version (``fec.device.conv_k3_decode_plain``, the entry
    point ``conv_k3_decode_batch`` on CPU tensors) against the JAX
    ``conv_k3_decode_batch`` and the host ``_viterbi_k3``, bit for bit:
    header codewords with 0-2 injected errors, random words, and the
    tie-heavy all-zero and all-one words; and the card kernel's own
    arithmetic (metrics less the common branch cost, the byte-table
    traceback), modelled in numpy, against the JAX function on any
    uint8 input;
  - ``fec.device.dstar_ambe_ecc_batch`` against the JAX function on
    encoded frames with 0-3 errors and on random frames: parameters and
    error counts equal;
  - both device decoders (``dstar_header_decode_device``,
    ``dstar_voice_decode_device``) on random dibits at chosen positions,
    pad hits included: blobs equal byte for byte;
  - the pipeline on the stream of ``data/event_tables.npz`` at C = 3, two
    1.5 s blocks with the contexts kept: the accepted frames and their
    records equal, every channel's event lines, positions and fields
    equal, ``channel_state`` equal, and the records hold the vector's
    headers and superframes (``protocol.dstar.encode.judge``).

The JAX functions are jitted, as its pipelines call them.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")           # the card's machine has none
jnp = jax.numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from dsdneo_tpu.engine import dstarbatch as J  # noqa: E402
from dsdneo_tpu.fec import device as jdev  # noqa: E402
from dsdneo_tpu.protocol.dstar import ambe2400 as jambe  # noqa: E402
from dsdneo_tpu.protocol.dstar import decoder as jdec  # noqa: E402
from dsdneo_tpu_torch import params  # noqa: E402
from dsdneo_tpu_torch.engine import dstarbatch as P  # noqa: E402
from dsdneo_tpu_torch.fec import device as tdev  # noqa: E402
from dsdneo_tpu_torch.protocol.dmr.encode import vector_block  # noqa: E402
from dsdneo_tpu_torch.protocol.dstar import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.protocol.dstar import encode as dstar_encode  # noqa
from dsdneo_tpu_torch.protocol.dstar.encode import fm_iq  # noqa: E402

import export_torch_tables as X  # noqa: E402

BLOCK_DIBITS = 7200                 # 1.5 s at 4800 baud
LEADS = (0, 41, 96)


@pytest.fixture(scope="module")
def tables():
    return params.load_event("dstar", "cpu")


def _k3_words(rng, n):
    """Header codewords of random info bits (two flush bits) with 0-2
    flipped bits each, random words, all-zero and all-one words."""
    words = []
    for i in range(n):
        info = np.concatenate([rng.integers(0, 2, 328), [0, 0]]).astype(
            np.uint8)
        w = X._dstar_k3_encode(info)
        w[rng.choice(660, size=i % 3, replace=False)] ^= 1
        words.append(w)
    words += [rng.integers(0, 2, 660).astype(np.uint8) for _ in range(4)]
    words += [np.zeros(660, np.uint8), np.ones(660, np.uint8)]
    return np.stack(words)


def test_k6_plain_matches_jax_and_host_viterbi():
    """Tolerance 0: hard bits make every metric a small integer."""
    words = _k3_words(np.random.default_rng(6), 18)
    got = tdev.conv_k3_decode_batch(torch.as_tensor(words))
    assert got.dtype == torch.uint8 and got.shape == (len(words), 330)
    want = np.asarray(jax.jit(jdev.conv_k3_decode_batch)(
        jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), want)
    host = np.stack([jdec._viterbi_k3(w) for w in words])
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(
        tdev.conv_k3_decode_plain(torch.as_tensor(words)).numpy(), want)


def test_k6_plain_short_words():
    """Lengths other than the header's 660: the lattice does not depend
    on it."""
    rng = np.random.default_rng(1)
    for n2 in (2, 6, 38):
        w = rng.integers(0, 2, (5, n2)).astype(np.uint8)
        np.testing.assert_array_equal(
            tdev.conv_k3_decode_plain(torch.as_tensor(w)).numpy(),
            np.asarray(jdev.conv_k3_decode_batch(jnp.asarray(w))))


def _k6_kernel_model(words):
    """Kernel K6's arithmetic (``csrc/conv_k3.cu``) in numpy: the metrics
    kept less the branch cost s1 + s0 every candidate carries (u = +1
    for a zero input, -1 otherwise), each state's take bit set only when
    pb is strictly cheaper, the end state the first of least metric, and
    the traceback through each step's byte table of next states (byte st
    holds (st >> 1) + 2 * take_b(st)).  Returns the bits and the largest
    metric magnitude seen."""
    N, n = words.shape[0], words.shape[1] // 2
    s1 = words[:, 0::2].astype(np.int64)
    s0 = words[:, 1::2].astype(np.int64)
    m = np.zeros((N, 4), np.int64)
    takes = np.zeros((N, n), np.int64)
    peak = 0
    for t in range(n):
        u1 = np.where(s1[:, t] == 0, 1, -1)
        u0 = np.where(s0[:, t] == 0, 1, -1)
        w = u1 + u0
        pairs = ((m[:, 0], m[:, 2] + w), (m[:, 0] + w, m[:, 2]),
                 (m[:, 1] + u1, m[:, 3] + u0), (m[:, 1] + u0, m[:, 3] + u1))
        new = []
        for k, (a, b) in enumerate(pairs):
            took_b = b < a
            takes[:, t] |= took_b.astype(np.int64) << k
            new.append(np.where(took_b, b, a))
        m = np.stack(new, axis=1)
        peak = max(peak, int(np.abs(m).max()))
    st = np.argmin(m, axis=1)
    out = np.zeros((N, n), np.uint8)
    for t in range(n - 1, -1, -1):
        out[:, t] = st & 1
        table = 0x01010000 + 2 * ((takes[:, t] * 0x00204081) & 0x01010101)
        st = (table >> (8 * st)) & 0xFF
    return out, peak


@pytest.mark.parametrize("kind", ["codewords", "bytes", "sparse", "ties"])
def test_k6_kernel_arithmetic_decides_as_the_jax_function(kind):
    """The card kernel's reformulation (relative metrics, the byte-table
    traceback) against the jitted JAX function, bit for bit, on any
    uint8 input; the metrics stay within +-2n."""
    rng = np.random.default_rng(len(kind))
    if kind == "codewords":
        words = _k3_words(rng, 12)
    elif kind == "bytes":
        words = rng.integers(0, 256, (24, 660)).astype(np.uint8)
    elif kind == "sparse":
        words = (rng.integers(0, 256, (24, 98)) *
                 (rng.random((24, 98)) < 0.3)).astype(np.uint8)
    else:
        words = np.stack([np.zeros(40, np.uint8), np.ones(40, np.uint8),
                          np.full(40, 255, np.uint8),
                          np.tile([0, 1], 20).astype(np.uint8),
                          np.tile([1, 0, 0, 1], 10).astype(np.uint8)])
    got, peak = _k6_kernel_model(words)
    want = np.asarray(jax.jit(jdev.conv_k3_decode_batch)(
        jnp.asarray(words)))
    np.testing.assert_array_equal(got, want)
    assert peak <= words.shape[1]


def test_dstar_ambe_ecc_matches_jax(tables):
    rng = np.random.default_rng(4)
    b49 = rng.integers(0, 2, (40, 49)).astype(np.uint8)
    frames = np.stack([jambe.encode_dstar_ambe_ecc(b) for b in b49])
    for i in range(40):
        frames[i, rng.choice(72, size=i % 4, replace=False)] ^= 1
    frames = np.concatenate(
        [frames, rng.integers(0, 2, (24, 72)).astype(np.uint8)])
    got_b, got_e = tdev.dstar_ambe_ecc_batch(torch.as_tensor(frames), tables)
    want_b, want_e = (np.asarray(a) for a in
                      jdev.dstar_ambe_ecc_batch(jnp.asarray(frames)))
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    # the clean frames decode to their parameters
    np.testing.assert_array_equal(got_b.numpy()[:40:4], b49[::4])


def test_device_decoders_blobs_equal(tables):
    rng = np.random.default_rng(9)
    C, T = 3, 3000
    dibits = rng.integers(0, 4, (C, T)).astype(np.uint8)
    ch = np.array([0, 2, 1, 2, C, C], np.int64)         # two pad hits
    pos = np.array([0, 700, 981, 2976, 0, 0], np.int64)  # clipped at T
    dt = torch.as_tensor(dibits)
    for jf, tf in ((J.dstar_header_decode_device,
                    lambda d, c, p: P.dstar_header_decode_device(d, c, p)),
                   (J.dstar_voice_decode_device,
                    lambda d, c, p: P.dstar_voice_decode_device(d, c, p,
                                                                tables))):
        want = np.asarray(jf(jnp.asarray(dibits), jnp.asarray(ch, np.int32),
                             jnp.asarray(pos, np.int32)))
        got = tf(dt, torch.as_tensor(ch), torch.as_tensor(pos)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_tables_equal_the_jax_constants(tables):
    scram, inv, sd = P._dstar_tables()
    for a, b in zip((scram, inv, sd), J._dstar_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(P._voice_offsets(), J._voice_offsets()):
        np.testing.assert_array_equal(a, b)
    for i, r in enumerate(jambe._row_positions()):
        np.testing.assert_array_equal(
            getattr(tables, f"dstar_r{i}").numpy(), r)
    hdr = np.frombuffer(b"\0\0\0DIRECT  DIRECT  CQCQCQ  W1AW    ID51"
                        + bytes(2), np.uint8)
    assert tdec.crc16_x25(hdr[:39]) == jdec.crc16_x25(hdr[:39])
    assert tdec.voicing_activity(np.arange(49) % 2) == \
        jambe.voicing_activity(np.arange(49) % 2)


def _blocks(tv, leads, seed):
    """Two consecutive 1.5 s blocks of the stream per channel (the second
    starts where the first ends), own lead and noise per channel."""
    out = []
    for b in range(2):
        tvb = dict(tv, dibits=tv["dibits"][b * BLOCK_DIBITS:])
        if b:
            tvb["lead"] = np.concatenate([tv["lead"], tv["dibits"]])[
                :b * BLOCK_DIBITS + len(tv["lead"])]
        out.append(vector_block(tvb, leads, seed + 10 * b
                                + np.arange(len(leads)), BLOCK_DIBITS * 10,
                                modulate=fm_iq, lead_dibits=tvb["lead"]))
    return out


def _events(pipe, c):
    return [(e.line, e.pos, sorted((k, np.asarray(v).tolist())
                                   for k, v in e.fields.items()))
            for e in pipe.events(c)]


def test_pipeline_matches_jax_on_the_stream(tables):
    tv = tables.test_vector()
    C = len(LEADS)
    tp = P.BatchedDstarPipeline(C, device="cpu", tables=tables)
    jp = J.BatchedDstarPipeline(C)
    n_checked = 0
    for blk, iq in enumerate(_blocks(tv, LEADS, 30)):
        got = tp.decode_block_records(torch.as_tensor(iq))
        want = jp.decode_block_records(jnp.asarray(iq))
        assert [g[:3] for g in got] == [w[:3] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[3], w[3])
        assert tp.decode_block_events(iq) == jp.decode_block_events(
            jnp.asarray(iq))
        ac, at, ak, asc, recs = tp.last_frames
        for c in range(C):
            assert _events(tp, c) == _events(jp, c)
            assert tp.channel_state(c) == jp.channel_state(c)
            # the second block's vector positions are the first's less
            # the block length
            tvb = dict(tv, hd_starts=tv["hd_starts"] - blk * BLOCK_DIBITS,
                       sf_starts=tv["sf_starts"] - blk * BLOCK_DIBITS)
            n_checked += dstar_encode.judge(
                tvb, LEADS[c], BLOCK_DIBITS - 2,
                [(int(t), int(k), float(s), r) for cc, t, k, s, r
                 in zip(ac, at, ak, asc, recs) if cc == c])
    assert n_checked >= 12


def test_preamble_hit_can_take_the_header_slot_in_both():
    """Pins a fault of the JAX pick that the port copies (ROADMAP queue
    3): on a stream with a 32-symbol alternating preamble and no dead
    air at its start, channel 0's preamble before the second header
    scores 0.606 on the header pattern, the schedule takes that hit
    (its CRC fails, under the 0.68 floor it emits nothing) and skips the
    true header 30 symbols later.  Both packages pick the same frames;
    the other two channels keep every header."""
    dv = {k[len("dstar_tv_"):]: v for k, v in X._dstar_vector(
        preamble=32, opening=0).items()}
    iq = X._event_check_block(dv, fm_iq)
    tp = P.BatchedDstarPipeline(3, device="cpu",
                                tables=params.load_event("dstar", "cpu"))
    jp = J.BatchedDstarPipeline(3)
    picks = []
    for pipe, x in ((tp, torch.as_tensor(iq)), (jp, jnp.asarray(iq))):
        _d, pat, pos, vq, n_sym = pipe.frontend_sync_device(x)
        picks.append([tuple(int(v) for v in row) for row in zip(
            *pipe.pick_frames(pat, pos, vq, n_sym)[:3])])
    assert picks[0] == picks[1]
    hd0 = [t for c, t, k in picks[0] if c == 0 and k == 1]
    second = X.EV_CHECK_LEADS[0] + int(dv["hd_starts"][1])
    assert any(second - 40 < t < second - 20 for t in hd0)
    assert not any(abs(t - second) <= 2 for t in hd0)
    for c in (1, 2):
        got = [t for cc, t, k in picks[0] if cc == c and k == 1]
        want = X.EV_CHECK_LEADS[c] + dv["hd_starts"]
        assert all(any(abs(t - w) <= 2 for t in got)
                   for w in want if w + 684 <= n_sym - 2)
