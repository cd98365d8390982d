"""ProVoice and the EDACS serial frame reader of the PyTorch port against
the JAX package's (``protocol/provoice/``, ``protocol/edacs/decoder.py``),
on the CPU.  All of it is numpy in both packages, so everything is held
equal, bit for bit:

  - the IMBE-7100 ECC (a labelled hypothesis, ``PARITY.md``; the port is
    held to the JAX package, not to off-air truth): the carried cells,
    the cases of ``tests/test_provoice_ecc.py`` (the round trip, injected
    errors, the grader on encoded and on random frames) and 500 random
    frames with errors, with and without the PN;
  - the pair interleave: ``pair_bit_schedule``, ``interleave_pair`` and
    its round trip through ``ProVoiceDecoder._load_pair``, the superframe
    and stream constructors;
  - ``ProVoiceDecoder.handle`` and ``EdacsDecoder.handle`` on the
    superframes and frames of ``data/serial_tables.npz``: clean,
    inverted, with bit errors, cut short, the EA sync, and EDACS with a
    BCH failure, the ESK mask and the EA catalog: event lines, fields
    and the resume position equal.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.protocol import base as jbase  # noqa: E402
from dsdneo_tpu.protocol.edacs import decoder as jed  # noqa: E402
from dsdneo_tpu.protocol.provoice import decoder as jpv  # noqa: E402
from dsdneo_tpu.protocol.provoice import encode as jenc  # noqa: E402
from dsdneo_tpu.protocol.provoice import imbe7100 as j71  # noqa: E402
from dsdneo_tpu.symbols import framesync as jfs  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.protocol import base as tbase  # noqa: E402
from dsdneo_tpu_torch.protocol.edacs import decoder as ted  # noqa: E402
from dsdneo_tpu_torch.protocol.provoice import decoder as tpv  # noqa: E402
from dsdneo_tpu_torch.protocol.provoice import encode as tenc  # noqa: E402
from dsdneo_tpu_torch.protocol.provoice import imbe7100 as t71  # noqa: E402
from dsdneo_tpu_torch.symbols import framesync as tfs  # noqa: E402


def test_tables_equal():
    assert tpv._W == jpv._W and tpv._X == jpv._X
    assert t71.carried_positions() == j71.carried_positions()
    assert tenc.pair_bit_schedule() == jenc.pair_bit_schedule()


def test_ecc_cases_of_the_jax_tests():
    # round trip (test_roundtrip_exact)
    rng = np.random.default_rng(0)
    for _ in range(16):
        bits = rng.integers(0, 2, 90).astype(np.uint8)
        fr = j71.encode_imbe7100_ecc(bits)
        np.testing.assert_array_equal(fr, t71.encode_imbe7100_ecc(bits))
        a, b = j71.decode_imbe7100_ecc(fr), t71.decode_imbe7100_ecc(fr)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1] == 0
    # injected errors (test_corrects_injected_errors)
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 90).astype(np.uint8)
    fr = j71.encode_imbe7100_ecc(bits)
    cells = j71.carried_positions()
    for base, width, n in ((0, 23, 3), (23, 23, 3), (46, 23, 2),
                           (92, 15, 1)):
        for off in rng.choice(width, size=n, replace=False):
            w, x = cells[base + int(off)]
            fr[w, x] ^= 1
    a, b = j71.decode_imbe7100_ecc(fr), t71.decode_imbe7100_ecc(fr)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] == 9
    # the grader (test_grader_*)
    rng = np.random.default_rng(2)
    frames = np.stack([j71.encode_imbe7100_ecc(
        rng.integers(0, 2, 90).astype(np.uint8)) for _ in range(24)])
    assert j71.grade_hypotheses(frames) == t71.grade_hypotheses(frames)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 2, (24, 7, 24)).astype(np.uint8)
    assert j71.grade_hypotheses(frames) == t71.grade_hypotheses(frames)


@pytest.mark.parametrize("pn", [True, False])
def test_ecc_random_frames(pn):
    rng = np.random.default_rng(4 + pn)
    for _ in range(500):
        bits = rng.integers(0, 2, 90).astype(np.uint8)
        fr = j71.encode_imbe7100_ecc(bits, pn=pn)
        np.testing.assert_array_equal(fr, t71.encode_imbe7100_ecc(bits, pn=pn))
        fr = fr.copy()
        fr[rng.integers(0, 7, 5), rng.integers(0, 24, 5)] ^= 1
        a, b = (j71.decode_imbe7100_ecc(fr, pn=pn),
                t71.decode_imbe7100_ecc(fr, pn=pn))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


def test_pair_interleave_round_trip():
    rng = np.random.default_rng(6)
    for _ in range(50):
        f1, f2 = rng.integers(0, 2, (2, 7, 24)).astype(np.uint8)
        s = jenc.interleave_pair(f1, f2)
        np.testing.assert_array_equal(s, tenc.interleave_pair(f1, f2))
        cur = [0]

        def take(n):
            out = s[cur[0]:cur[0] + n]
            cur[0] += n
            return out
        g1, g2 = tpv.ProVoiceDecoder._load_pair(take)
        cells = np.zeros((7, 24), bool)
        for tag, w, x in tenc.pair_bit_schedule():
            if tag == "1":
                cells[w, x] = True
        np.testing.assert_array_equal(g1[cells], f1[cells])
        assert cur[0] == len(s)
        fr = rng.integers(0, 2, (4, 7, 24)).astype(np.uint8)
        lid, bf = (int(v) for v in rng.integers(0, 1 << 16, 2))
        np.testing.assert_array_equal(
            jenc.encode_provoice_superframe(fr, lid=lid, bf=bf),
            tenc.encode_provoice_superframe(fr, lid=lid, bf=bf))
        np.testing.assert_array_equal(
            jenc.provoice_stream_dibits(fr, lid=lid, bf=bf),
            tenc.provoice_stream_dibits(fr, lid=lid, bf=bf))


def _handle_both(cls_j, cls_t, dibits, sync_name, state=None):
    out = []
    for fs, base, cls in ((jfs, jbase, cls_j), (tfs, tbase, cls_t)):
        sd = next(d for d in fs.SYNC_DEFS if d.name == sync_name)
        hit = fs.SyncHit(pos=0, score=1.0, sync=sd)
        ctx = base.DecoderContext()
        for k, v in (state or {}).items():
            setattr(ctx.state, k, v)
        r = base.DibitReader(dibits.copy(), np.zeros(len(dibits), np.float32),
                             pos=hit.end, frame_start=0, invert=sd.inverted)
        out.append((ctx, cls().handle(r, hit, ctx)))
    (jc, je), (tc, te) = out
    assert je == te
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    return tc


@pytest.mark.parametrize("case", ["clean", "inverted", "errors", "short",
                                  "ea"])
def test_provoice_handle(case):
    tv = SV.vector()
    frames = np.unpackbits(tv["pv_frames"], axis=-1)[..., :24]
    rng = np.random.default_rng(7)
    for i in range(0, 40, 4):
        p = int(tv["pv_pos"][i])
        d = tv["pv_dibits"][p:p + SV.PV_SUPERFRAME_DIBITS].copy()
        name = "+ProVoice"
        if case == "inverted":
            d ^= 2
            name = "-ProVoice"
        elif case == "errors":
            idx = rng.choice(np.arange(32, len(d)), 20, replace=False)
            d[idx] ^= 2
        elif case == "short":
            d = d[:500]
        elif case == "ea":
            name = "+ProVoice EA"
        tc = _handle_both(jpv.ProVoiceDecoder, tpv.ProVoiceDecoder, d, name)
        if case in ("clean", "inverted", "ea"):
            e = tc.events[-1]
            assert (e.fields["lid"], e.fields["bf"]) == (
                int(tv["pv_lid"][i]), int(tv["pv_bf"][i]))
            np.testing.assert_array_equal(e.fields["imbe7100_frames"],
                                          frames[i])


@pytest.mark.parametrize("case", ["clean", "inverted", "bch_fail", "esk",
                                  "ea", "short"])
def test_edacs_handle(case):
    tv = SV.vector()
    rng = np.random.default_rng(8)
    state = {"esk": {"edacs_esk": 0xA5}, "ea": {"edacs_ea": True}}.get(case)
    n_ok = 0
    for i in range(0, 120, 3):
        p = int(tv["pv_edacs_pos"][i])
        d = tv["pv_dibits"][p:p + SV.EDACS_FRAME_DIBITS].copy()
        name = "+EDACS"
        if case == "inverted":
            d[48:] ^= 2                      # the words complemented
        elif case == "bch_fail":
            d[48 + rng.choice(240, 60, replace=False)] ^= 2
        elif case == "short":
            d = d[:200]
        tc = _handle_both(jed.EdacsDecoder, ted.EdacsDecoder, d, name,
                          state)
        if case == "short":
            assert not tc.events             # the frame is not whole
            continue
        e = tc.events[-1]
        if case in ("clean", "inverted"):
            assert e.fields["word"] == int(tv["pv_edacs_word"][i])
            assert e.line.startswith("Sync: -EDACS" if case == "inverted"
                                     else "Sync: +EDACS")
        n_ok += "word" in e.fields
    assert n_ok > 0 or case in ("bch_fail", "short")
