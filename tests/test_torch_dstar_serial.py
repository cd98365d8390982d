"""The D-STAR serial decoder of the PyTorch port against the JAX
package's, on the CPU.

Module parity on inputs drawn from seeds with numpy: the header's K=3
Viterbi (``_viterbi_k3``) on coded words with 0-3 bit errors, the AMBE
3600x2400 ECC (``decode_dstar_ambe_ecc``, ``encode_dstar_ambe_ecc``,
the interleave tables, ``voicing_activity``) on frames with 0-3 errors,
the slow-data cases of ``tests/test_dstar_slowdata.py`` (radio text, a
DPRS position, an unknown type) through both packages'
``DstarDecoder._slow_data``; ``DstarDecoder.handle`` on random 2-level
streams with hits of every D-STAR sync and the stream's headers and
superframes pasted in (the pattern of ``tests/test_fuzz_robustness.py``),
both packages' events equal.

``demod_fm`` for ``dstar`` (2-level, 4800 symbols/s, the ``6k25``
profile): the dibits equal off the slicer's threshold, the soft symbols
within 1e-3.

``decode_samples`` end to end (``device="cpu"``) on ~4 s of the
``dstar_*`` stream of ``data/serial_tables.npz``: every event's line,
position, protocol and fields (the on-air voice bits, ``ambe49`` and
``ambe_errs``) equal, the dibits equal, the port's decode holding the
vector (``engine.serialvec.judge_dstar``); neither package synthesizes
D-STAR voice.
"""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.engine import demod as jdemod  # noqa: E402
from dsdneo_tpu.protocol import base as jbase  # noqa: E402
from dsdneo_tpu.protocol.dstar import ambe2400 as jambe  # noqa: E402
from dsdneo_tpu.protocol.dstar import decoder as jds  # noqa: E402
from dsdneo_tpu.symbols import framesync as jfs  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import demod as tdemod  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.protocol import base as tbase  # noqa: E402
from dsdneo_tpu_torch.protocol.dstar import ambe2400 as tambe  # noqa: E402
from dsdneo_tpu_torch.protocol.dstar import decoder as tds  # noqa: E402
from dsdneo_tpu_torch.symbols import framesync as tfs  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from export_torch_tables import _dstar_k3_encode  # noqa: E402

DSTAR_SYM = 4 * 4800                 # 4 s of the D-STAR stream
SOFT_TOL = 1e-3
EDGE = 0.05


def test_dstar_stream():
    tv = SV.vector()
    x = SV.dstar_iq(tv, DSTAR_SYM)
    jc = jdec.decode_samples(x, "dstar")
    tc = tdec.decode_samples(x, "dstar", device="cpu")
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    np.testing.assert_array_equal(jc.dibits, tc.dibits)
    assert not jc.audio and not tc.audio
    got = SV.judge_dstar(tv, tc, DSTAR_SYM)
    assert got["headers"] >= 2 and got["superframes"] >= 7
    assert min(got["text"], got["dprs"], got["header_copies"]) >= 1


@pytest.mark.parametrize("n_err", [0, 1, 2, 3])
def test_viterbi_k3(n_err):
    rng = np.random.default_rng(70 + n_err)
    for _ in range(6):
        info = np.concatenate([rng.integers(0, 2, 328),
                               np.zeros(2, np.int64)]).astype(np.uint8)
        coded = _dstar_k3_encode(info)
        coded[rng.choice(660, n_err, replace=False)] ^= 1
        a, b = jds._viterbi_k3(coded), tds._viterbi_k3(coded)
        np.testing.assert_array_equal(a, b)
        if n_err <= 1:
            np.testing.assert_array_equal(b, info)
    assert tds._V_TRANS == jds._V_TRANS
    assert tds._V_DECODED == jds._V_DECODED


@pytest.mark.parametrize("n_err", [0, 1, 2, 3])
def test_dstar_ambe_ecc(n_err):
    rng = np.random.default_rng(80 + n_err)
    for _ in range(40):
        b49 = rng.integers(0, 2, 49).astype(np.uint8)
        w = tambe.encode_dstar_ambe_ecc(b49)
        np.testing.assert_array_equal(w, jambe.encode_dstar_ambe_ecc(b49))
        w[rng.choice(72, n_err, replace=False)] ^= 1
        (ja, je), (ta, te) = (jambe.decode_dstar_ambe_ecc(w),
                              tambe.decode_dstar_ambe_ecc(w))
        np.testing.assert_array_equal(ja, ta)
        assert je == te
        if n_err == 0:
            np.testing.assert_array_equal(ta, b49)
            assert te == 0
        for a, b in zip(jambe.deinterleave_dstar72(w),
                        tambe.deinterleave_dstar72(w)):
            np.testing.assert_array_equal(a, b)
        assert tambe.voicing_activity(ta) == jambe.voicing_activity(ja)
        assert tds.voicing_activity is tambe.voicing_activity
    for a, b in zip(jambe._row_positions(), tambe._row_positions()):
        np.testing.assert_array_equal(a, b)
    cw = rng.integers(0, 2, 23).astype(np.uint8)
    assert tambe._seed12(cw) == jambe._seed12(cw)


def _sd_bits(sd_bytes):
    """Inverse of ``DstarDecoder._slow_data``'s descramble, reverse and
    pack (``tests/test_dstar_slowdata._bits_from_bytes``)."""
    sd2 = np.zeros(480, dtype=np.uint8)
    for i in range(60):
        b = int(sd_bytes[59 - i])
        for k in range(8):
            sd2[i * 8 + k] = (b >> (7 - k)) & 1
    return sd2[::-1] ^ np.tile(tds.SD_SCRAMBLE, 20)


def _slow_data_cases():
    text = np.zeros(60, np.uint8)
    text[0] = 0x40
    msg = "HELLO FROM DSDNEO TPU"
    j = 0
    for i in range(1, 59):
        if i % 6 and j < len(msg):
            text[i] = ord(msg[j])
            j += 1
    dprs = np.zeros(60, np.uint8)
    dprs[0] = 0x35
    body = " " * 25 + "!4217.93N/07148.65W>"
    k = 0
    for i in range(1, 60):
        if i % 6 == 0:
            continue
        if i in (1, 2, 3, 4, 5):
            dprs[i] = ord("$$CRC "[i - 1])
        elif k < len(body):
            dprs[i] = ord(body[k])
        if i > 5:
            k += 1
    return {"text": text, "dprs": dprs,
            "unknown": np.full(60, 0xAA, np.uint8),
            "header": SV.vector()["dstar_sf_sd"][0]}


@pytest.mark.parametrize("case", ["text", "dprs", "unknown", "header"])
def test_slow_data(case):
    sd = _slow_data_cases()[case]
    jc, tc = jbase.DecoderContext(), tbase.DecoderContext(device="cpu")
    a = jds.DstarDecoder()._slow_data(_sd_bits(sd), jc)
    b = tds.DstarDecoder()._slow_data(_sd_bits(sd), tc)
    assert a == b
    for attr in ("dstar_text", "dstar_gps", "last_src"):
        assert getattr(jc.state, attr, None) == getattr(tc.state, attr,
                                                        None)
    want = {"text": "HELLO FROM DSDNEO TPU",
            "dprs": "APRS - Lat: 42d 17m 93s N", "unknown": "SLOW DATA",
            "header": "SRC: W1AW"}[case]
    assert want in b


def _fuzz(pkg, dibits, soft, picks):
    base, fs = (jbase, jfs) if pkg == "jax" else (tbase, tfs)
    ds = jds if pkg == "jax" else tds
    ctx = (base.DecoderContext() if pkg == "jax"
           else base.DecoderContext(device="cpu"))
    dec = ds.DstarDecoder()
    defs = [d for d in fs.SYNC_DEFS if d.protocol == "dstar"]
    for pos, k in picks:
        hit = fs.SyncHit(pos=pos, score=0.9, sync=defs[k])
        dec.handle(base.DibitReader(dibits, soft, pos=hit.end,
                                    frame_start=hit.pos,
                                    invert=hit.sync.inverted), hit, ctx)
    return ctx


@pytest.mark.parametrize("seed", range(4))
def test_handle_on_random_streams(seed):
    rng = np.random.default_rng(600 + seed)
    tv = SV.vector()
    dibits = np.where(rng.integers(0, 2, 12000) > 0, 3, 1).astype(np.uint8)
    h = int(tv["dstar_hd_pos"][seed])
    inv = seed % 2 == 1
    # a header and its first superframe, upright or inverted
    dibits[500:500 + 684 + 2016] = tv["dstar_dibits"][h:h + 2700] ^ (
        2 if inv else 0)
    picks = [(500, 3 if inv else 2), (500 + 684, 1 if inv else 0)] + [
        (int(p), int(rng.integers(0, 4)))
        for p in sorted(rng.integers(3300, 11990, 4))]
    soft = rng.normal(0, 3, 12000).astype(np.float32)
    jc = _fuzz("jax", dibits, soft, picks)
    tc = _fuzz("torch", dibits, soft, picks)
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    assert len(tc.events) >= 4
    assert "(CRC ERR)" not in tc.events[0].line
    assert not np.any(tc.events[1].fields["ambe_errs"])


def test_demod_fm():
    x = SV.dstar_iq(SV.vector(), DSTAR_SYM // 2)
    jd, js = jdemod.demod_fm(x, "dstar")
    td, ts = tdemod.demod_fm(x, "dstar", device="cpu")
    assert np.abs(np.asarray(js) - ts).max() <= SOFT_TOL
    off = np.abs(np.asarray(js)) > EDGE
    assert off.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(jd)[off], td[off])
