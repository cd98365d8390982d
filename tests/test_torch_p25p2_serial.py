"""The P25 Phase 2 serial decoder of the PyTorch port against the JAX
package's, on the CPU.

``decode_samples(..., "p25p2")`` end to end (``device="cpu"``) on the
``p2_*`` stream of ``data/serial_tables.npz`` (superframes of the JAX
package's ``synth_p2_voice_stream``, a clear half then an ADP-keyed
half, the LCCH timeslots replaced by scrambled MAC_PTT SACCH bursts):
its whole 60 s with the scramble parameters and the ADP key, and 4 s
windows of the clear and the keyed half: with the parameters and the
key, with them and no key, and blind (no parameters: the scramble seed
recovered from the RS parity of a SACCH burst).  Every event's line,
position, protocol and fields equal, the AMBE parameter bits handed to
the vocoder equal (``serialvec.AmbeSpy``), each slot's PCM (the jitter
ring's 160-sample frames) within 2e-3 of the JAX package's peak; the
port's decodes hold the vector (``serialvec.judge_p2``).

The ESS soft-erasure knob (``DSD_NEO_P25P2_SOFT_ERASURE_THRESHOLD``): a
2V burst whose ESS carries 15 symbol errors, 8 of them in the sweep's
first window, fails its RS decode; with the knob the sweep runs and its
15-symbol correction is rejected by the decoder's own gate, in both
packages alike.  The jitter ring
(``runtime.jitter.P2AudioJitterRing``) against the JAX class on random
pushes and pops, and the ISCH lookup on its default table.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.crypto.keyring import KeyRing as JKeyRing  # noqa: E402
from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.protocol.p25 import p2_xcch as jx  # noqa: E402
from dsdneo_tpu.runtime import config as jcfg  # noqa: E402
from dsdneo_tpu.runtime import jitter as jjit  # noqa: E402
from dsdneo_tpu.vocoder import mbe as jmbe  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.protocol.p25 import encode as tenc  # noqa: E402
from dsdneo_tpu_torch.protocol.p25 import p2_xcch as tx  # noqa: E402
from dsdneo_tpu_torch.runtime import config as tcfg  # noqa: E402
from dsdneo_tpu_torch.runtime import jitter as tjit  # noqa: E402
from dsdneo_tpu_torch.vocoder import mbe as tmbe  # noqa: E402

PCM_REL = 2e-3
WIN = 4 * 6000                       # 4 s windows


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    """Both packages read the environment afresh in each test."""
    monkeypatch.setattr(jcfg, "_config", None)
    monkeypatch.setattr(tcfg, "_config", None)


def _iq(dib: np.ndarray) -> np.ndarray:
    return SV._noisy(tenc.tdma_fm_iq(dib, SV.P2_SPS), False, 0)


def _both(x, keyed: bool, blind: bool):
    """Both packages' ``decode_samples(x, "p25p2")`` with the AMBE bits
    kept; the events, bits and PCM equal.  Returns the port's (ctx,
    spy)."""
    tv = SV.vector()
    out = []
    for dec, mod in ((jdec, jmbe), (tdec, tmbe)):
        kr = None
        if keyed:
            kr = JKeyRing() if dec is jdec else SV.keyring(tv)
            kr.scalar[int(tv["p2_ids"][4])] = int(tv["p2_ids"][3])
        kw = {"device": "cpu"} if dec is tdec else {}
        with SV.AmbeSpy(mod) as spy:
            ctx = dec.decode_samples(
                x, "p25p2", keyring=kr,
                p2_params=None if blind else SV.p2_params(tv), **kw)
        out.append((ctx, spy))
    (jc, js), (tc, ts) = out
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    assert len(js.bits) == len(ts.bits)
    if js.bits:
        np.testing.assert_array_equal(np.stack(js.bits), np.stack(ts.bits))
    assert sorted(jc.audio) == sorted(tc.audio)
    for slot in jc.audio:
        a, b = SV.pcm(jc, slot), SV.pcm(tc, slot)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
    return tc, ts


def test_p2_stream_against_jax():
    tv = SV.vector()
    ctx, spy = _both(SV.p2_iq(tv), keyed=True, blind=False)
    got = SV.judge_p2(tv, ctx, spy)
    assert got["frames"] == len(tv["p2_frame_pos"])
    assert got["decrypted"] >= 2900 and got["ess"] >= 330


@pytest.mark.parametrize("half", ["clear", "keyed"])
@pytest.mark.parametrize("case", ["key", "no_key", "blind"])
def test_p2_windows_against_jax(half, case):
    tv = SV.vector()
    start = 0 if half == "clear" else int(
        tv["p2_frame_pos"][3 * (int(tv["p2_halves"][0]) - 1)]) - 48
    x = _iq(tv["p2_dibits"][start:start + WIN])
    ctx, spy = _both(x, keyed=case != "no_key", blind=case == "blind")
    lines = [e.line for e in ctx.events]
    assert sum("4V" in line for line in lines) >= 80
    if case == "blind":
        assert any("recovered from RS parity" in line for line in lines)
    if half == "clear":
        got = SV.judge_p2(tv, ctx, spy, WIN, keyed=case != "no_key",
                          blind=case == "blind")
        assert got["voice_frames"] >= 360
    elif case == "key":
        assert sum(" MI: 0x1122334455667788" in line
                   for line in lines) >= 15


def test_ess_soft_erasure_knob(monkeypatch):
    """15 symbol errors in a 2V burst's ESS: RS(63,35) fails, and the
    knob's erasure sweep runs (its first window covers 8 of them) in
    both packages alike.  The sweep's decode corrects 8 erasures and 7
    errors, 15 symbols, which the ``0 <= nerr < 15`` gate of
    ``_process_ess`` rejects as the JAX package does: the burst shows no
    ESS either way."""
    from dsdneo_tpu_torch.fec import rs as trs
    tv = SV.vector()
    fp = tv["p2_frame_pos"]
    f = 3 * (int(tv["p2_halves"][0]) + 2) + 2     # a keyed 2V frame
    start = int(fp[f - 5]) - 48
    dib = tv["p2_dibits"][start:start + WIN].copy()
    ts0 = int(fp[f]) - start + 20               # the frame's 2V of slot 0
    dib[ts0 + 74:ts0 + 119] ^= 3                # its bits 148-237
    x = _iq(dib)
    code = trs.rs_63_35()
    real = code.decode
    swept = []

    def decode(word, erasures=None):
        out = real(word, erasures)
        if erasures == list(range(35, 43)):     # the sweep's first window
            swept.append(out[1])
        return out

    monkeypatch.setattr(code, "decode", decode)
    lines = {}
    for thr in ("0", "64"):
        monkeypatch.setenv("DSD_NEO_P25P2_SOFT_ERASURE_THRESHOLD", thr)
        monkeypatch.setattr(jcfg, "_config", None)
        monkeypatch.setattr(tcfg, "_config", None)
        n = len(swept)
        ctx, _spy = _both(x, keyed=True, blind=False)
        lines[thr] = [e.line for e in ctx.events]
        hit = [e.line for e in ctx.events if e.pos == int(fp[f]) - start
               and e.fields.get("ts") == 0]
        assert hit == ["       P25p2 LCH 0 2V"]
        assert (len(swept) > n) == (thr == "64")
    assert lines["0"] == lines["64"]
    assert swept and swept[0] == 15


def test_jitter_ring():
    rng = np.random.default_rng(3)
    a, b = jjit.P2AudioJitterRing(6), tjit.P2AudioJitterRing(6)
    for _ in range(400):
        op = int(rng.integers(0, 5))
        slot = int(rng.integers(-1, 3))
        if op == 0:
            pcm = rng.normal(size=int(rng.integers(0, 1200))).astype(
                np.float32)
            assert a.push_pcm(slot, pcm) == b.push_pcm(slot, pcm)
        elif op == 1:
            fr = rng.normal(size=int(rng.choice([160, 159]))).astype(
                np.float32)
            assert a.push(slot, fr) == b.push(slot, fr)
        elif op == 2:
            (fa, oka), (fb, okb) = a.pop(slot), b.pop(slot)
            assert oka == okb
            np.testing.assert_array_equal(fa, fb)
        elif op == 3 and slot in (0, 1):
            assert a.depth(slot) == b.depth(slot)
        else:
            a.reset(slot)
            b.reset(slot)
    assert a.dropped == b.dropped and a.underruns == b.underruns


def test_isch_lookup_default_table():
    rng = np.random.default_rng(4)
    words = [jx.isch_codeword(int(v)) for v in rng.integers(0, 128, 50)]
    words += [w ^ int(m) for w, m in zip(words, rng.integers(0, 1 << 40,
                                                             50))]
    words += [w ^ (1 << int(b)) ^ (1 << int(c)) for w, b, c in zip(
        words, rng.integers(0, 40, 50), rng.integers(0, 40, 50))]
    for w in words:
        assert jx.isch_lookup(w) == tx.isch_lookup(w)
