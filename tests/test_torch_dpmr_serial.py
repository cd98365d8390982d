"""The dPMR serial decoder of the PyTorch port against the JAX package's,
on the CPU.

Module parity on inputs drawn from seeds with numpy: ``crc7_dpmr``, the
scramble sequence, the de-interleave and channel-code tables,
``air_interface_id``, ``DpmrDecoder._cch`` on CCHs with 0-2 bit errors;
``DpmrDecoder.handle`` on random dibit streams with hits of every dPMR
sync (the pattern of ``tests/test_fuzz_robustness.py``), both packages'
events equal.

``demod_fm`` for ``dpmr`` (2400 symbols/s, the ``6k25`` profile): the
dibits equal off the slicer's thresholds, the soft symbols within 1e-3.

``decode_samples`` end to end (``device="cpu"``) on ~4 s of the
``dpmr_*`` stream of ``data/serial_tables.npz`` from its start (the FS1
header, FS2 parts, the FS3 parts that the hunt finds by their FS3),
upright and on an inverted channel (where the FS1 header reads as an
FS4 end and the FS4 end as an FS1 header, FS4 being FS1 negated): every
event's line, position, protocol and fields equal,
the dibits equal, the AMBE bits handed to ``decode_ambe_2450`` equal,
the port's decode holding the vector (``engine.serialvec.judge_dpmr``),
and the PCM within 2e-3 of the JAX package's peak.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.engine import demod as jdemod  # noqa: E402
from dsdneo_tpu.protocol import base as jbase  # noqa: E402
from dsdneo_tpu.protocol.dpmr import decoder as jdp  # noqa: E402
from dsdneo_tpu.symbols import framesync as jfs  # noqa: E402
import dsdneo_tpu.vocoder.mbe as jmbe  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import demod as tdemod  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.protocol import base as tbase  # noqa: E402
from dsdneo_tpu_torch.protocol.dpmr import decoder as tdp  # noqa: E402
from dsdneo_tpu_torch.symbols import framesync as tfs  # noqa: E402
import dsdneo_tpu_torch.vocoder.mbe as tmbe  # noqa: E402

DPMR_SYM = 4 * 2400                  # 4 s of the dPMR stream
PCM_REL = 2e-3
SOFT_TOL = 1e-3
EDGE = 0.05


def _both(x):
    with SV.AmbeSpy(jmbe) as js:
        jc = jdec.decode_samples(x, "dpmr")
    with SV.AmbeSpy(tmbe) as ts:
        tc = tdec.decode_samples(x, "dpmr", device="cpu")
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    np.testing.assert_array_equal(jc.dibits, tc.dibits)
    assert len(js.bits) == len(ts.bits) > 0
    np.testing.assert_array_equal(np.stack(js.bits), np.stack(ts.bits))
    a, b = SV.pcm(jc), SV.pcm(tc)
    assert a.shape == b.shape and b.dtype == np.float32
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
    return tc, ts


@pytest.mark.parametrize("channel", ["upright", "inverted"])
def test_dpmr_stream(channel):
    tv = SV.vector()
    invert = channel == "inverted"
    tc, ts = _both(SV.dpmr_iq(tv, DPMR_SYM, invert=invert))
    got = SV.judge_dpmr(tv, tc, ts, DPMR_SYM, invert=invert)
    assert got["parts"] >= 23 and got["fs3_parts"] >= 11
    assert got["ambe_frames"] >= 180 and got["headers"] == 1
    assert any(e.line.endswith("(end)") for e in tc.events) == invert


def test_crc_tables_and_ids():
    rng = np.random.default_rng(61)
    for _ in range(300):
        b = rng.integers(0, 2, int(rng.integers(1, 60))).astype(np.uint8)
        assert tdp.crc7_dpmr(b) == jdp.crc7_dpmr(b)
    for n in (1, 72, 200):
        np.testing.assert_array_equal(tdp._scramble_bits(n),
                                      jdp._scramble_bits(n))
    np.testing.assert_array_equal(tdp._DEINT_6x12, jdp._DEINT_6x12)
    assert tdp._CC_MAP == jdp._CC_MAP
    for v in rng.integers(0, 1 << 24, 200):
        assert tdp.air_interface_id(int(v)) == jdp.air_interface_id(int(v))


@pytest.mark.parametrize("n_err", [0, 1, 2])
def test_cch(n_err):
    """CCHs of the stream's parts, with ``n_err`` bits flipped in each
    Hamming word: the same corrected bits and flags."""
    tv = SV.vector()
    rng = np.random.default_rng(62 + n_err)
    dib = tv["dpmr_dibits"]
    jd, td = jdp.DpmrDecoder(), tdp.DpmrDecoder()
    for p in tv["dpmr_part_pos"][:40]:
        for off in (12, 204):
            dd = dib[p + off:p + off + 36]
            bits = np.stack([(dd >> 1) & 1, dd & 1], 1).reshape(-1)
            for w in range(6):
                if n_err:
                    bits[rng.choice(12, n_err, replace=False) * 6 + w] ^= 1
            a, b = jd._cch(bits.astype(np.uint8)), td._cch(
                bits.astype(np.uint8))
            np.testing.assert_array_equal(a[0], b[0])
            assert (a[1], a[2]) == (b[1], b[2])


def _fuzz(pkg, dibits, soft, picks):
    base, fs = (jbase, jfs) if pkg == "jax" else (tbase, tfs)
    dp = jdp if pkg == "jax" else tdp
    ctx = (base.DecoderContext() if pkg == "jax"
           else base.DecoderContext(device="cpu"))
    dec = dp.DpmrDecoder()
    defs = [d for d in fs.SYNC_DEFS if d.protocol == "dpmr"]
    for pos, k in picks:
        hit = fs.SyncHit(pos=pos, score=0.9, sync=defs[k])
        dec.handle(base.DibitReader(dibits, soft, pos=hit.end,
                                    frame_start=hit.pos,
                                    invert=hit.sync.inverted), hit, ctx)
    return ctx


@pytest.mark.parametrize("seed", range(6))
def test_handle_on_random_streams(seed):
    """Random dibits with hits of random dPMR syncs (FS3 near the start
    and parts running past the end included), some over parts of the
    stream: the same events and voice bits from both packages."""
    rng = np.random.default_rng(400 + seed)
    tv = SV.vector()
    dibits = rng.integers(0, 4, 6000).astype(np.uint8)
    p0 = int(tv["dpmr_part_pos"][2 * seed])
    dibits[1000:1000 + 768] = tv["dpmr_dibits"][p0:p0 + 768]
    soft = rng.normal(0, 3, 6000).astype(np.float32)
    picks = [(100, 2), (1000, 1), (1000 + 576, 2)] + [
        (int(p), int(rng.integers(0, 6)))
        for p in sorted(rng.integers(2000, 5990, 8))]
    with SV.AmbeSpy(jmbe) as js:
        jc = _fuzz("jax", dibits, soft, picks)
    with SV.AmbeSpy(tmbe) as ts:
        tc = _fuzz("torch", dibits, soft, picks)
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    # the FS3 at 100 steps back before the stream and emits nothing, as
    # does a part whose CCHs run past the end
    assert 6 <= len(tc.events) < len(picks)
    assert any("Channel Code=" in e.line for e in tc.events)
    assert len(js.bits) == len(ts.bits) > 0
    np.testing.assert_array_equal(np.stack(js.bits), np.stack(ts.bits))


def test_demod_fm():
    x = SV.dpmr_iq(SV.vector(), DPMR_SYM // 2)
    jd, js = jdemod.demod_fm(x, "dpmr")
    td, ts = tdemod.demod_fm(x, "dpmr", device="cpu")
    assert np.abs(np.asarray(js) - ts).max() <= SOFT_TOL
    off = np.min(np.abs(np.abs(js)[:, None] - np.array([0.0, 2.0])),
                 axis=1) > EDGE
    assert off.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(jd)[off], td[off])
