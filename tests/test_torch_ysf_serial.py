"""The YSF serial decoder of the PyTorch port against the JAX package's,
on the CPU.

Module parity on inputs drawn from seeds with numpy: ``ysf_crc16``, the
PN95 whitening, the name tables, ``_fr_slot_to_matrix`` and the IMBE
decode behind it (the round trip of ``tests/test_ysf.py``, replayed in
both packages), ``YsfDecoder._fich`` and ``_dch2`` on the stream's
fields with 0-3 bit errors; ``YsfDecoder.handle`` on random dibit
streams with hits of both YSF syncs (the pattern of
``tests/test_fuzz_robustness.py``), both packages' events equal.

``demod_fm`` for ``ysf`` (4800 symbols/s, the ``12k5`` profile): the
dibits equal off the slicer's thresholds, the soft symbols within 1e-3.

``decode_samples`` end to end (``device="cpu"``) on ~4 s of the
``ysf_*`` stream of ``data/serial_tables.npz`` (a full-rate call with
its CSD3 frames, a V/D2 call with its DCH2 text, the start of a V/D1
call, their header and terminator frames): every event's line,
position, protocol and fields equal, the dibits equal, the AMBE bits
handed to ``decode_ambe_2450`` and the IMBE bits handed to
``decode_imbe_4400`` equal, the port's decode holding the vector
(``engine.serialvec.judge_ysf``), and the PCM within 2e-3 of the JAX
package's peak.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.engine import demod as jdemod  # noqa: E402
from dsdneo_tpu.protocol import base as jbase  # noqa: E402
from dsdneo_tpu.protocol.p25 import imbe_frame as jimbe  # noqa: E402
from dsdneo_tpu.protocol.ysf import decoder as jys  # noqa: E402
from dsdneo_tpu.symbols import framesync as jfs  # noqa: E402
import dsdneo_tpu.vocoder.mbe as jmbe  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import demod as tdemod  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.protocol import base as tbase  # noqa: E402
from dsdneo_tpu_torch.protocol.p25 import imbe_frame as timbe  # noqa: E402
from dsdneo_tpu_torch.protocol.ysf import decoder as tys  # noqa: E402
from dsdneo_tpu_torch.symbols import framesync as tfs  # noqa: E402
import dsdneo_tpu_torch.vocoder.mbe as tmbe  # noqa: E402

YSF_SYM = 4 * 4800                   # 4 s of the YSF stream
PCM_REL = 2e-3
SOFT_TOL = 1e-3
EDGE = 0.05


def _spies(mbe):
    return SV.AmbeSpy(mbe), SV.AmbeSpy(mbe, "decode_imbe_4400")


def _equal_spies(a, b):
    assert len(a.bits) == len(b.bits)
    if a.bits:
        np.testing.assert_array_equal(np.stack(a.bits), np.stack(b.bits))


def test_ysf_stream():
    tv = SV.vector()
    x = SV.ysf_iq(tv, YSF_SYM)
    ja, ji = _spies(jmbe)
    with ja, ji:
        jc = jdec.decode_samples(x, "ysf")
    ta, ti = _spies(tmbe)
    with ta, ti:
        tc = tdec.decode_samples(x, "ysf", device="cpu")
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    np.testing.assert_array_equal(jc.dibits, tc.dibits)
    _equal_spies(ja, ta)
    _equal_spies(ji, ti)
    a, b = SV.pcm(jc), SV.pcm(tc)
    assert a.shape == b.shape and np.isfinite(b).all()
    assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
    got = SV.judge_ysf(tv, tc, ta, ti, YSF_SYM)
    assert got["frames"] >= 38 and got["hc_tc"] >= 4
    assert min(got["vd1"], got["vd2"], got["vwfr"], got["csd3"]) >= 4
    assert got["imbe_frames"] >= 30 and got["ambe_frames"] >= 100
    text = "\n".join(e.line for e in tc.events)
    assert "DST: ALL        " in text and "SRC: W1AW      " in text


def test_crc_and_tables():
    rng = np.random.default_rng(63)
    for _ in range(300):
        b = rng.integers(0, 2, int(rng.integers(1, 120))).astype(np.uint8)
        assert tys.ysf_crc16(b) == jys.ysf_crc16(b)
    for n in (1, 100, 512):
        np.testing.assert_array_equal(tys._pn95_bits(n), jys._pn95_bits(n))
    np.testing.assert_array_equal(tys._FR_INTERLEAVE, jys._FR_INTERLEAVE)
    assert tys._FR_ROW_LENS == jys._FR_ROW_LENS
    assert (tys.DT_NAMES, tys.CM_NAMES, tys.FI_NAMES) == (
        jys.DT_NAMES, jys.CM_NAMES, jys.FI_NAMES)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_fr_slot_round_trip(seed):
    """``tests/test_ysf.py``'s round trip in both packages: an IMBE frame
    matrix through the FR interleave to dibits, back through
    ``_fr_slot_to_matrix`` and ``decode_imbe_fr``."""
    rng = np.random.default_rng(seed)
    bits88 = rng.integers(0, 2, 88).astype(np.uint8)
    bits144 = jimbe.encode_imbe_ecc(bits88)
    fr = np.zeros((8, 23), np.uint8)
    for j in range(72):
        fr[jimbe.IMBE_W[j]][jimbe.IMBE_X[j]] = bits144[2 * j]
        fr[jimbe.IMBE_Y[j]][jimbe.IMBE_Z[j]] = bits144[2 * j + 1]
    vch = np.zeros(144, np.uint8)
    k = 0
    for n, mlen in enumerate(jys._FR_ROW_LENS):
        for m in range(mlen - 1, -1, -1):
            vch[k] = fr[n][m]
            k += 1
    raw = np.zeros(144, np.uint8)
    raw[jys._FR_INTERLEAVE] = vch
    seg = ((raw[0::2] << 1) | raw[1::2]).astype(np.uint8)
    for flips in (0, 1, 3):
        s = seg.copy()
        s[rng.choice(72, flips, replace=False)] ^= 1
        a, b = jys._fr_slot_to_matrix(s), tys._fr_slot_to_matrix(s)
        np.testing.assert_array_equal(a, b)
        ja, je = jimbe.decode_imbe_fr(a)
        ta, te = timbe.decode_imbe_fr(b)
        np.testing.assert_array_equal(ja, ta)
        assert je == te
        if flips == 0:
            np.testing.assert_array_equal(b, fr)
            np.testing.assert_array_equal(ta, bits88)


@pytest.mark.parametrize("n_err", [0, 1, 3])
def test_fich_and_dch2(n_err):
    """The FICH and DCH2 of the stream's frames with ``n_err`` dibits
    changed: the same fields, text and CRC verdicts."""
    tv = SV.vector()
    rng = np.random.default_rng(64 + n_err)
    jd, td = jys.YsfDecoder(), tys.YsfDecoder()
    jctx, tctx = jbase.DecoderContext(), tbase.DecoderContext(device="cpu")
    n_ok = 0
    for f, p in enumerate(tv["ysf_frame_pos"][:60]):
        dd = tv["ysf_dibits"][p + 20:p + 480].copy()
        dd[rng.choice(460, n_err, replace=False)] ^= rng.integers(1, 4, n_err
                                                                  ).astype(
            np.uint8)
        a, b = jd._fich(dd[:100]), td._fich(dd[:100])
        assert a == b
        if n_err == 0:
            assert b == tuple(int(v) for v in tv["ysf_fich"][f][[0, 1]]) + \
                (0, 0) + tuple(int(v) for v in tv["ysf_fich"][f][2:])
        fn, cm = int(tv["ysf_fich"][f][2]), int(tv["ysf_fich"][f][1])
        pa, pb = jd._dch2(dd[100:], fn, cm, jctx), td._dch2(dd[100:], fn, cm,
                                                             tctx)
        assert pa == pb
        n_ok += "CRC ERR" not in pb
    assert n_ok >= 10


def _fuzz(pkg, dibits, soft, picks):
    base, fs = (jbase, jfs) if pkg == "jax" else (tbase, tfs)
    ys = jys if pkg == "jax" else tys
    ctx = (base.DecoderContext() if pkg == "jax"
           else base.DecoderContext(device="cpu"))
    dec = ys.YsfDecoder()
    defs = [d for d in fs.SYNC_DEFS if d.protocol == "ysf"]
    for pos, k in picks:
        hit = fs.SyncHit(pos=pos, score=0.9, sync=defs[k])
        dec.handle(base.DibitReader(dibits, soft, pos=hit.end,
                                    frame_start=hit.pos,
                                    invert=hit.sync.inverted), hit, ctx)
    return ctx


@pytest.mark.parametrize("seed", range(4))
def test_handle_on_random_streams(seed):
    """Random dibits with hits of both YSF syncs, and frames of the
    stream (each mode) pasted in: the same events, voice bits and PCM
    from both packages."""
    rng = np.random.default_rng(500 + seed)
    tv = SV.vector()
    dibits = rng.integers(0, 4, 8000).astype(np.uint8)
    picks = []
    fich = tv["ysf_fich"]
    for slot, f in enumerate(rng.choice(np.flatnonzero(fich[:, 0] == 1),
                                        6, replace=False)):
        p = int(tv["ysf_frame_pos"][f])
        at = 200 + 600 * slot
        inv = bool(rng.integers(0, 2))
        dibits[at:at + 480] = tv["ysf_dibits"][p:p + 480] ^ (2 if inv else 0)
        picks.append((at, int(inv)))
    picks += [(int(p), int(rng.integers(0, 2)))
              for p in rng.integers(3800, 7990, 4)]
    picks.sort()
    soft = rng.normal(0, 3, 8000).astype(np.float32)
    ja, ji = _spies(jmbe)
    with ja, ji:
        jc = _fuzz("jax", dibits, soft, picks)
    ta, ti = _spies(tmbe)
    with ta, ti:
        tc = _fuzz("torch", dibits, soft, picks)
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    assert len(tc.events) >= 6
    _equal_spies(ja, ta)
    _equal_spies(ji, ti)
    assert len(ta.bits) + len(ti.bits) >= 12


def test_demod_fm():
    x = SV.ysf_iq(SV.vector(), YSF_SYM // 2)
    jd, js = jdemod.demod_fm(x, "ysf")
    td, ts = tdemod.demod_fm(x, "ysf", device="cpu")
    assert np.abs(np.asarray(js) - ts).max() <= SOFT_TOL
    off = np.min(np.abs(np.abs(js)[:, None] - np.array([0.0, 2.0])),
                 axis=1) > EDGE
    assert off.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(jd)[off], td[off])
