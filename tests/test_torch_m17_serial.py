"""The M17 serial decoder of the PyTorch port against the JAX package's,
on the CPU.

Module parity on inputs drawn from seeds with numpy: the stream
scrambler's LFSR (``scrambler_keystream``, the three subtypes, from a
seed and advanced over a gap), the AES-CTR counter, the depuncturing of
P1, P2 and P3, the LSF META readers (text blocks assembled over LSFs,
GNSS, extended callsign, raw) and the M17 IP frames (``ip.py``: stream
and packet frames built and parsed, control frames).

``decode_samples(..., "m17")`` end to end (``device="cpu"``, the keys
of ``serialvec.m17_attrs``) on the ``m17_*`` stream of
``data/serial_tables.npz``: its whole 60 s upright, and its first cycle
of transmissions (a clear call with META text, a 1600 call with A_DATA,
scrambler calls of the three subtypes, one with dropped frames and one
heard from its 12th frame, an SMS packet, a GNSS META, AES-CTR, a
signed stream, an extended callsign, a BERT run) on an inverted
channel: every event's line, position, protocol and fields equal, the
payload each voice frame hands Codec2 equal (``serialvec.M17Spy``), the
M17 IP frames sent to ``m17_udp`` byte for byte, and the PCM within
2e-3 of the JAX package's peak where libcodec2 loads, each package's
decode in a fresh process (libcodec2 draws its unvoiced excitation from
one noise generator for the whole process, so two decodes in one
process differ).  The port's upright decode holds the vector
(``serialvec.judge_m17``), each feature counted.
"""

import numpy as np
import pytest

pytest.importorskip("jax")                 # the card's machine has none

from dsdneo_tpu.crypto.keystream import aes_ctr_keystream as jaes  # noqa: E402,E501
from dsdneo_tpu.engine import decoder as jdec  # noqa: E402
from dsdneo_tpu.protocol.m17 import decoder as jm17  # noqa: E402
from dsdneo_tpu.protocol.m17 import ip as jip  # noqa: E402
from dsdneo_tpu_torch.engine import decoder as tdec  # noqa: E402
from dsdneo_tpu_torch.engine import serialvec as SV  # noqa: E402
from dsdneo_tpu_torch.protocol.m17 import decoder as tm17  # noqa: E402
from dsdneo_tpu_torch.protocol.m17 import ip as tip  # noqa: E402
from dsdneo_tpu_torch.vocoder import codec2  # noqa: E402

PCM_REL = 2e-3


def _cycle_end(tv) -> int:
    """The symbol where the stream's first cycle (through its BERT run)
    ends."""
    fr = tv["m17_frames"]
    bert = int(np.flatnonzero(tv["m17_tx"][:, 0] == 2)[0])
    return int(fr[fr[:, 2] == bert, 0].max()) + 200


def _both(x):
    """Both packages' ``decode_samples(x, "m17")`` with the vector's
    keys, their voice payloads and IP frames kept."""
    tv = SV.vector()
    out = []
    for dec, mod in ((jdec, jm17), (tdec, tm17)):
        udp = SV.UdpSink()
        kw = {"device": "cpu"} if dec is tdec else {}
        with SV.M17Spy(mod.M17Decoder) as spy:
            ctx = dec.decode_samples(x, "m17", m17_udp=udp,
                                     state_attrs=SV.m17_attrs(tv), **kw)
        out.append((ctx, spy, udp))
    return out


def _same(j, t):
    (jc, js, ju), (tc, ts, tu) = j, t
    assert SV.events_equal(jc.events, tc.events) is None, \
        SV.events_equal(jc.events, tc.events)
    assert SV.sinks_equal((js, ju), (ts, tu))
    # the PCM's length here, its values in fresh processes
    # (test_m17_pcm_in_fresh_processes)
    assert SV.pcm(jc).shape == SV.pcm(tc).shape
    assert bool(SV.pcm(tc).size) == codec2.available()


@pytest.fixture(scope="module")
def whole():
    tv = SV.vector()
    j, t = _both(SV.m17_iq(tv))
    _same(j, t)
    return t


def test_m17_stream_against_jax(whole):
    tctx, spy, udp = whole
    got = SV.judge_m17(SV.vector(), tctx, spy, udp)
    assert got["voice_frames"] >= 1200 and got["lsf_from_lich"] >= 150


@pytest.mark.parametrize("feature,least", [
    ("lsfs", 30), ("decrypted", 500), ("verified", 3), ("sms", 4),
    ("bert_frames", 11)])
def test_m17_features(whole, feature, least):
    tctx, spy, udp = whole
    assert SV.judge_m17(SV.vector(), tctx, spy, udp)[feature] >= least


@pytest.mark.parametrize("what", ["meta_text", "gnss", "ext_callsign",
                                  "a_data", "late_entry", "gap"])
def test_m17_lines(whole, what):
    """The stream's lines of each kind in the port's decode; the payloads
    it hands Codec2 at a late entry (on-air until the LICH gives the
    LSF, then decrypted) and after dropped frames (decrypted across the
    gap)."""
    tctx, spy = whole[0], whole[1]
    tv = SV.vector()
    lines = [e.line for e in tctx.events]
    fr = tv["m17_frames"]
    onair = np.unpackbits(tv["m17_onair"], axis=-1)
    handed = np.unpackbits(tv["m17_handed"], axis=-1)
    if what in ("late_entry", "gap"):
        col = 4 if what == "late_entry" else 6
        tx = np.flatnonzero(tv["m17_tx"][:, col] > 0)
        rows = fr[np.isin(fr[:, 2], tx) & (fr[:, 1] == SV.M17_STR), 5]
        cipher = [np.array_equal(spy.bits[r], onair[r]) for r in rows]
        for r in rows:
            np.testing.assert_array_equal(spy.bits[r], handed[r])
        if what == "late_entry":        # five a transmission read clear
            assert sum(cipher) == 5 * len(tx)
        else:
            assert not any(cipher)
            fns = fr[np.isin(fr[:, 2], tx) & (fr[:, 1] == SV.M17_STR), 3]
            assert np.sum(np.diff(fns & 0x7FFF) == 4) == len(tx)
        return
    key = {"meta_text": "Meta Text Data: CQ M17 RUN",
           "gnss": "Meta GNSS Position Data Lat:",
           "ext_callsign": "Meta Extended Callsign Data:",
           "a_data": "\n A_DATA: AD "}[what]
    assert sum(key in line for line in lines) >= 4


def test_m17_inverted_channel_against_jax():
    tv = SV.vector()
    j, t = _both(SV.m17_iq(tv, _cycle_end(tv), invert=True))
    _same(j, t)
    assert sum("-M17 STR" in e.line for e in t[0].events) >= 250


@pytest.mark.parametrize("subtype", [0, 1, 2, 3])
def test_scrambler_keystream(subtype):
    rng = np.random.default_rng(subtype)
    for _ in range(20):
        state = int(rng.integers(0, 1 << 24))
        n = int(rng.integers(0, 700))
        a, sa = jm17.scrambler_keystream(subtype, state, n)
        b, sb = tm17.scrambler_keystream(subtype, state, n)
        np.testing.assert_array_equal(a, b)
        assert sa == sb
        # advanced over a gap, then read
        ga, gsa = jm17.scrambler_keystream(subtype, sa, 128)
        gb, gsb = tm17.scrambler_keystream(subtype, sb, 128)
        np.testing.assert_array_equal(ga, gb)
        assert gsa == gsb


def test_aes_ctr_counter():
    rng = np.random.default_rng(5)
    for _ in range(50):
        meta = rng.integers(0, 256, 14).astype(np.uint8).tobytes()
        fn = int(rng.integers(0, 1 << 16))
        assert jm17.aes_ctr_counter(meta, fn) == tm17.aes_ctr_counter(meta,
                                                                      fn)
    key = bytes(range(32))
    iv = tm17.aes_ctr_counter(bytes(14), 7)
    from dsdneo_tpu_torch.crypto.keystream import aes_ctr_keystream
    np.testing.assert_array_equal(aes_ctr_keystream(key, iv, 16),
                                  jaes(key, iv, 16))


@pytest.mark.parametrize("pattern,out_len", [("_P1", 488), ("_P2", 296),
                                             ("_P3", 420)])
def test_depuncture(pattern, out_len):
    rng = np.random.default_rng(out_len)
    sym = rng.random(368).astype(np.float32)
    a = jm17._depuncture(sym, getattr(jm17, pattern), out_len)
    b = tm17._depuncture(sym, getattr(tm17, pattern), out_len)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_meta_readers():
    """``_meta_text_block`` over a three-block text sent out of order and
    ``_meta_decode`` on GNSS, extended-callsign and raw METAs."""
    from dsdneo_tpu_torch.protocol.base import DecoderContext as TCtx
    from dsdneo_tpu.protocol.base import DecoderContext as JCtx
    rng = np.random.default_rng(9)
    dj, dt = jm17.M17Decoder(), tm17.M17Decoder()
    text = b"HELLO FROM THE M17 SERIAL PATH, BLOCK BY BLOCK"
    for idx in (1, 0, 2):
        meta = np.frombuffer(bytes([0x70 | (1 << idx)])
                             + text[13 * idx:13 * idx + 13].ljust(13),
                             np.uint8)
        assert dj._meta_text_block(meta) == dt._meta_text_block(meta)
    metas = [np.frombuffer(bytes([0x81, 0, 0x6F, 0x2E]) + rng.integers(
        0, 256, 10).astype(np.uint8).tobytes(), np.uint8),
        np.frombuffer(b"\x91" + bytes(13), np.uint8),
        np.frombuffer(b"\x82W1AW/MOBILE\x00\x01", np.uint8),
        rng.integers(0, 256, 14).astype(np.uint8)]
    for meta in metas:
        for gnss in (True, False):
            cj, ct = JCtx(), TCtx()
            assert (jm17.M17Decoder._meta_decode(meta, cj, gnss)
                    == tm17.M17Decoder._meta_decode(meta, ct, gnss))
            assert (getattr(cj.state, "m17_gps", None)
                    == getattr(ct.state, "m17_gps", None))


def test_ip_frames():
    rng = np.random.default_rng(11)
    for _ in range(20):
        lsf = rng.integers(0, 2, 240).astype(np.uint8)
        v = rng.integers(0, 2, 128).astype(np.uint8)
        sid, fn = int(rng.integers(0, 1 << 16)), int(rng.integers(0, 1 << 15))
        eot = bool(rng.integers(0, 2))
        a = jip.pack_stream_frame(lsf, sid, fn, eot, v)
        assert a == tip.pack_stream_frame(lsf, sid, fn, eot, v)
        pay = rng.integers(0, 256, int(rng.integers(1, 60))).astype(
            np.uint8).tobytes()
        b = jip.pack_packet_frame(lsf, sid, pay)
        assert b == tip.pack_packet_frame(lsf, sid, pay)
        for raw in (a, b, b"PING" + pay, a[:-1] + bytes([a[-1] ^ 1]),
                    b"XYZW" + pay, a[:20]):
            fj, ft = jip.parse_ip_frame(raw), tip.parse_ip_frame(raw)
            assert (fj is None) == (ft is None)
            if fj is not None:
                for k in ("kind", "sid", "dst", "src", "type_word", "fn",
                          "eot", "payload", "crc_ok"):
                    assert getattr(fj, k) == getattr(ft, k), k
                if fj.voice is not None:
                    np.testing.assert_array_equal(fj.voice, ft.voice)


@pytest.mark.parametrize("invert", [False, True])
def test_m17_pcm_in_fresh_processes(invert, tmp_path):
    """Each package's PCM of the stream's first cycle, each decoded in a
    fresh process (libcodec2's noise generator is one for the whole
    process): within 2e-3 of the JAX package's peak."""
    if not codec2.available():
        pytest.skip("libcodec2 does not load: M17 emits no PCM")
    import os
    import subprocess
    import sys
    tv = SV.vector()
    n = _cycle_end(tv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = os.path.join(str(tmp_path), "jax_pcm.npy")
    code = ("import numpy as np, jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            "from dsdneo_tpu.engine import decoder\n"
            "from dsdneo_tpu_torch.engine import serialvec as SV\n"
            "tv = SV.vector()\n"
            f"ctx = decoder.decode_samples(SV.m17_iq(tv, {n}, {invert}), "
            "'m17', state_attrs=SV.m17_attrs(tv))\n"
            f"np.save({out!r}, SV.pcm(ctx))\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   env=dict(os.environ, PYTHONPATH=root), timeout=600)
    a = np.load(out)
    b = SV.m17_pcm_fresh(n, "cpu", invert)
    assert a.shape == b.shape and a.size > 50000
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= PCM_REL * np.abs(a).max()
